"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels  # phases 1-2 only: build + check
    python3 chip_smoke.py --moe-seed N  # phase 1, then phase 18 alone
                                     # on weights and batch from seed N
    python3 chip_smoke.py --ps       # the card line, then phases 20-24
                                     # alone (no kernel lies on them)
    python3 chip_smoke.py --elastic  # phase 1, then phase 19b alone
    python3 chip_smoke.py --online   # phase 1, the GPT-3 XL engine and
                                     # its store, then phase 13d alone
    python3 chip_smoke.py --router   # phase 1, the C7 check, the GPT-3
                                     # XL engine, the slo phase and two
                                     # published versions, then phase
                                     # 13e alone
    python3 chip_smoke.py --read-parts  # phase 1, then where one read of
                                     # the GPT-3 XL checkpoint goes
    python3 chip_smoke.py --ops      # phase 1, then phase 11a alone
    python3 chip_smoke.py --seq      # the card line, then phase 11b
                                     # alone (no kernel lies on it)
    python3 chip_smoke.py --help     # this text
    python3 chip_smoke.py --profile  # also: device-time breakdowns of
                                     # 10 decode steps, of one GPT train
                                     # step, of one BERT train step, of
                                     # three steps of each static
                                     # program, of one ResNet-50
                                     # train step and of three
                                     # wide&deep steps (torch.profiler)

Phases:
  1. card and build — the card's name and power limit, then nvcc builds
     every kernel of the port from ``paddle_tpu_torch/ops/csrc``, one
     process per source, all at once;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the GPT-3 XL serving and training paths give it, with its
     time (CUDA events, median, L2 flushed between launches), the plain
     version's time, one PyTorch library call chain's time as a
     yardstick, and the least time the card could take (bytes over HBM
     rate or flops over the peak rate of the input type, whichever is
     larger): paged attention (the split-context kernel, f32 and bf16
     caches, on ctx 1 ... 2048 and on the serving run's short contexts
     with its table width; each row with its split count, a
     bit-identical rerun, its error from both plain versions (the split
     one, P in f32 like the kernel, within 2e-5 for both caches; the
     gather one, P rounded to the cache's type like the JAX package's
     paged_attention_xla, within 2e-5 / 2e-2) and device time a call
     beside the SDPA yardstick's; each row on the vector route), then
     the scalar route at the shape of the d = 256 serving run (S = 4,
     H = 2, d = 256, pages of 16, f32: the path's), with its
     instantiations and layouts at that shape (bf16 pools; q and pools
     in bf16; in f16; f32 pools 4 bytes off a 16-byte boundary), each
     held to both plain versions (the split one within 2e-5, 2e-2 for a
     bf16 or f16 q), the two sub-blocks at decode (f32,
     M = 8, the stream route, with device_ms beside the SIMT kernel's on
     misaligned copies (held to the plain version too) and the library
     chain's, split_ms: the time at every K split beside stream_splits'
     pick, and the stream_max_rows sweep: stream against SIMT at 16, 32,
     64 and 127 rows, the evidence for _STREAM_MAX_ROWS) and at the
     256-row prefill bucket (f32, the FFMA route, with tile_ms: the time
     on every output tile, beside the tile ffma_tiles picks), the
     sub-blocks at the training shape
     (bf16, M = 1024 tokens, the tensor-core route), and the three flash
     kernels at B=1, H=16, T=1024, D=128, causal, in bf16 (the
     tensor-core route) and f32 (SIMT); each sub-block and flash row
     names the route it took (``tc``, ``ffma``, ``stream`` or ``simt``;
     a sub-block
     row on another route than its shape's fails), each flash row the
     share of its elements that
     differ from the plain version (bf16: at most 1%), and the bf16 rows
     (here and in phase 6) give device time per call (tc_times: calls
     queued behind a spin kernel, so the wrapper's host time is not
     counted) beside call_ms, one call timed by events;
  3. the serving path — ``Engine(GPTDecodeModel(GPTConfig.gpt3_1p3b()))``
     serves a request mix (greedy, seeded-sampled, and a shared-prefix
     pair that takes prefill_tail); every request must end "done", every
     kernel of the path must have launched, every decode launch of the
     sub-blocks must take the stream route, every prefill launch below
     128 rows the route stream_route gives it and every prefill launch
     at a bucket of 128 rows or more the FFMA route (launches by route
     and kind of call in sub_block_routes), every paged-attention call
     must take the vector kernel, and one greedy request must decode the
     same tokens when served by the plain versions on the card; then a
     2-layer GPT with heads of 256 (hidden 512, 2 heads), which the
     reference serves and the first paged kernel refused, served through
     Engine: every paged-attention call on the scalar kernel, greedy
     tokens equal to the plain versions' (serving_wide_heads);
  4. train parity — ``HybridParallelTrainStep`` on GPT-3 XL cut to 2
     layers at full width, bf16, 3 steps of 1 x 1024 tokens, through the
     kernels (flash, fused sub-blocks) and through the composed chain,
     same weights and ids: every step's loss must agree within 2e-2
     relative;
  5. the training path — the repo's GPT-3 XL train step (bench.py's
     bench_gpt_1p3b: bf16, flash, remat, dp=pp=tp=1, clip 1.0, batch 1 x
     1024), 1 warm-up + 4 timed steps: finite losses, the last below the
     first, every training kernel launched, and all 48 launches a step
     of each sub-block and of flash_fwd, and all 24 of flash_bwd_dq and
     flash_bwd_dkv, on the tensor-core route; step ms, tokens/s, MFU
     and peak device memory; then one step of the same at dropout 0.1
     (fault C4): the loss finite and the launches of rows 2-5, route by
     route, those of one dropout-0 step;
  6. BERT: the kernels at the shapes the BERT-base pretrain step gives
     them (phase 2b, run with the other kernel checks): layer norm and
     dropout + residual + layer norm, forward and backward, at R = 2048
     and R = 304 rows of C = 768, f32 and bf16, p = 0 and 0.1, with
     bit-equal dropout masks; all four kernels on the route ln_route
     picks ("warp"), beside the row route (on misaligned copies) and the
     warp route on every grid (grid_ms), reruns bit-identical, row 7 at
     p = 0 writing one gradient (dx_is_dres); the queued
     launch floor; the two sub-blocks at M = 2048 with dropout, post-norm and the
     erf-polynomial gelu (f32 on the FFMA route, with tile_ms, and bf16
     on the tensor cores); the three flash kernels at B=16, H=12, S=128,
     D=64, non-causal, with dropout, with and without a padding mask;
     and fault C3 (check_flash_block_override): with the reference's
     PADDLE_TPU_FLASH_BLOCK_Q / _K at 64, both flash routes at
     B=1 H=2 T=1024 D=64 bf16 round P at 64-key blocks, as the plain
     versions do (o at most 1% of its elements another bf16 number);
  7. BERT train parity — ``make_train_step`` on BERT-base cut to 2
     layers at full width, dropout 0.1, AMP O1, 3 steps with fixed
     seeds, through the kernels and through the composed chains
     (``nn.functional.composed_ops``) on the card: every step's loss
     must agree within 2e-2 relative;
  8. the BERT training path — bench.py's bench_bert configuration whole
     (BERT-base, batch 16 x 128, 19 masked positions a sequence, AdamW
     lr 1e-4, AMP O1, dropout 0.1), 1 warm-up + 4 timed steps: finite
     losses, the masked-LM term of the last below that of the first
     (the next-sentence term, 16 labels under Adam at lr 1e-4 without
     warm-up, overshoots and swings the sum by several nats from step to
     step), every kernel of the path launched as often as the model
     predicts, the 12 launches a step of each flash kernel (bf16) on the
     tensor-core route, of each sub-block (f32, M = 2048) on the FFMA
     route and of each layer-norm kernel (f32, R = 2048 and 304) on the
     warp route; step ms, samples/s, tokens/s, MFU and peak device
     memory;
  9. the encoder-layer phase — one ``TransformerEncoderLayer(768, 12,
     3072)`` with the constructor's defaults (relu, act_dropout =
     dropout = 0.1, post-LN), forward and backward at (16, 128, 768),
     kernels against composed chains; this is the route that launches
     the dropout + residual + layer norm kernels, once each way, both
     on the warp route;
 10. B row 10 (phase 2c, run with the other kernel checks): fused_ffn
     at the bert_base_512 preset (M = 8192, H = 768, I = 3072), at
     M = 2048 and at GPT-3 XL width in bf16, gelu and relu; f32 must
     take the FFMA route and bf16 the tensor cores; the preset in f32
     and bf16 with a misaligned x must take the SIMT kernel; reruns
     bit-identical,
     device time a call beside one call by events, the f32 preset's time
     on every pair of FFMA tiles;
 11. the static LeNet program (bench_lenet, batch 256) and the static FFN
     program at the preset on Executor(CUDAPlace(0)): losses fall, both
     fused_ffn launches a step on the FFMA route, kernel and composed
     losses within 1e-3, peak device memory, one eager run_op;
 11a. static_bert (item 11, the op library): (a) every op of
     ``fluid/ops`` on its CPU parity case's inputs (tests/
     torch_op_cases.py) on the card against the CPU, outputs within
     atol 1e-5 + rtol 1e-4 and its grad op's gradients within atol 1e-4
     + rtol 1e-3 (the random ops: shape and dtype); (b) the static BERT
     program (models/bert_static.py) at full width and 2 layers, batch
     4 x 128, dropout 0, 3 Lamb steps on the card and on the CPU from
     the same startup values: losses within 1e-3 relative; (c) BERT-base
     (12 layers, bench_bert's 16 x 128 with 304 masked positions, a
     padding mask, dropout 0.1, Lamb 1e-3) on Executor(CUDAPlace(0)),
     10 steps on one batch: the loss falls, step ms, peak memory, and
     rows 2-5 and 8-9 launched as static_bert_launches predicts on the
     FFMA / SIMT / warp routes; (d) a 2-layer program whose layer 1
     takes the activation dropout: rows 6-7 on the warp route; (e) the
     paged_attention op at GPT-3 XL decode, equal to the row-1 wrapper's
     direct call, one launch on the vector route. Its seconds beside the
     prediction (STATIC_BERT_PREDICTED_S);
 11b. static_lac (item 11, the op library's second part; no kernel of
     the port on this path): (a) every op of the sequence,
     structured-loss, misc and tail modules on its CPU parity case's
     inputs on the card against the CPU, as 11a (a) (the decompositions
     whose output is not unique held up to signs and by
     reconstruction; nce on the card's own samples); (b) the static LAC
     tagger (tests/torch_static_lac.py: sparse embedding 20,940 x 128,
     two bidirectional GRU layers of 128, 57 tags, linear-chain CRF,
     batch 300 x 64 with lengths 8-64) at full width, 3 SGD steps on the
     card and on the CPU from the same startup values: losses within
     1e-4 relative, at least 99.9% of the decoded tags equal; (c) LAC
     trained 20 steps on one batch on Executor(CUDAPlace(0)): the loss
     falls, crf_decoding under the EMA beats the batch's most frequent
     tag's share, median step ms, ops a step, peak memory, no kernel
     launched; (d) the sparse update: the embedding rows no id touches
     bit-equal after a step, the looked-up ones moved; (e) warpctc at a
     DeepSpeech2-like shape (B 16, T 400, 29 classes, labels up to 100)
     on the card against the CPU: loss within 1e-4 relative, gradient
     within 1e-3 of its largest entry, the card's ms. Its seconds beside
     the prediction (STATIC_LAC_PREDICTED_S);
 12. ResNet (no kernel of the port on this path: convolutions and pools
     are PyTorch's, batch norm the reference's arithmetic in tensor
     code) — resnet_parity: resnet18 at 32 x 32, batch 8, f32, NHWC,
     weights from seed 0, 3 momentum steps on the card and the same 3 on
     the CPU: losses within 1e-3 relative, running statistics within
     1e-4 (+ 1e-4 relative); then under O1 the class-separable batches of
     tests/test_vision_models.py on the card (lr 0.01): the loss falls
     over 6 steps. resnet50_phase: bench.py's bench_resnet50 whole (resnet50,
     1000 classes, NHWC, momentum lr 0.1, O1, batch 256 x 3 x 224 x 224
     resident on the card), 3 warm-up + 10 timed steps: step ms (median),
     images/s, MFU against the bf16 peak, peak memory, the finite loss,
     how far the running statistics moved, the port's launch counts (0),
     and the stem's output NHWC-contiguous on the card;
 13. checkpoints (item 2; checkpoint_phase, right after phase 3, on its
     engine): save the GPT-3 XL weights (f32, 1 MiB content-addressed
     chunks, each fsync'd) under a temporary root, save them again
     unchanged (every chunk a dedup hit, nothing written), build
     Engine.from_checkpoint with phase 3's engine arguments and replay
     phase 3's 8 requests in its order (every token equal, the seeded
     sampled request included), then warm_start(version=7) an engine on
     zero weights while its scheduler thread serves a request, and
     replay again (the same tokens, model_version 7); bytes, chunks,
     save / second-save / restore / warm-start seconds and GB/s, peak
     device memory; the root is removed, and a disk too small fails;
 13a. wire_serving (item 15): a ServingServer on 127.0.0.1:0 in front of
     a fresh engine with phase 3's arguments and weights; one
     ServingClient replays phase 3's requests in its order (request 0
     streamed first, the other seven on their own threads once its first
     token arrived, two more streamed, request 5 seeded and sampled):
     every token equal to phase 3's, ping_info / stats / metrics /
     debug_dump(write=False) answering, rows 1-3 launched in the phase
     (counts set to 0 just before, read just after), wire tokens/s
     beside phase 3's;
 13b. slo: bench.py's bench_slo mix (6 s diurnal, seed 7, prompts
     4/8/16/32, outputs 4/8/16, tenants 3:1, tiers 0/1/2 with deadlines
     10 s / 20 s / none, token ids under 512) at 8 requests/s, halved
     while the engine misses any deadline (down to 1/s), once with
     LoadGenerator.run_engine and once with run_client over the wire:
     both slo_reports (attainment, goodput, TTFT and inter-token
     percentiles) and the decode-step mean; a failed request or an
     out-of-range token fails, attainment does not;
 13c. chaos: bench_chaos's drill at that rate: the watchdog deadline
     (0.5 s) and a temporary PADDLE_TPU_DEBUG_DIR set before the engine
     is built, a 0.8 s stall armed at serving_decode; WATCHDOG.stalled()
     must name the engine within 30 s and drop it within 30 s of the
     stall clearing, and the watchdog's bundle must verify and hold the
     engine's requests; detection / recovery seconds and the
     post-recovery attainment delta;
 13d. online (items 17-18, on phase 3's engine and phase 13's store,
     which the checkpoint phase keeps for it): (a) online_staleness,
     bench_online's part (1): a PSServer publishing every 3 applied
     pushes, 5 rounds of 3 pushes of 8 x 64, push-to-servable seconds
     (p50, max) over the shard's pub_latest; the shard also hosts the
     telemetry collector (PADDLE_TPU_TELEMETRY_HOST=1); (b) online_swap:
     a Publisher over the checkpoint store behind a RegistryServer, a
     ServingServer(publish_root=) over the engine and a VersionSubscriber
     watching the registry over the wire; v1 = the same weights (every
     chunk a dedup hit), v2 = one row of wte one ulp up (one chunk
     rewritten); each read and uploaded off the step lock, its flip held
     until a streamed greedy request (phase 3's first prompt, 64 new
     tokens) is 4 frames in: publication, read + upload and flip
     seconds, the largest inter-token gap of the flip window beside the
     stream's median gap; gates: dedup 1.0 / >= 0.999, v2's digest new,
     model_version following, both streams whole and equal to the
     in-process tokens (whose first 24 are phase 3's), decode on the
     vector / stream kernels (rows 1-3: "online_launches");
     (c) online_telemetry: the process agent armed at the shard through
     (b): the engine's role in tel_fleet, an assembled trace of a wire
     generate, both swaps' flight events, decode-step samples from
     tsdb_query, a JSON threshold rule on a gauge the phase sets going
     pending -> firing -> resolved; then decode-step ms at 8 slots with
     the agent armed / disarmed and with the TSDB and alerts on / off
     (A/B/A, 60 steps a leg, no gate);
 13e. router (item 18's rest, on phase 3's weights and phase 13's store
     after 13d, router_phase): replica A a fresh engine with phase 3's
     slots and pool on the same weights behind a ServingServer with
     publish_root, replica B an InProcessReplica built from the store's
     step of the version 13d left (Engine.from_checkpoint), both
     warmed, no prefix cache; a Router with bench_router's probe
     settings; both must report one model_version before traffic.
     (a) bench_router over the wire: the slo traffic at 13b's held rate
     for max(8 s, B's start + 1 s + 5 s), fault-free, then again with B
     killed 2.5 s in and respawned from its checkpoint by the router:
     detect and recovery seconds, failovers, attainment (baseline,
     faulted, after recovery against the baseline's same window), wire
     TTFT / inter-token p50 and p99 beside 13b's wire figures; gates: no
     request error, no token out of range, every request done in both
     runs with the same tokens, one final reply a request. (b)
     bench_online's part (2): rollout_version to version 1 (published,
     served by neither) while 64-token streams of phase 3's first
     prompt run back to back through the router: the rollout's seconds,
     each replica's read + upload s and flip ms, the largest
     inter-token gap in each flip window beside the streams' median;
     gates: every stream whole, streams before the first flip and after
     the last equal to the in-process tokens on their weights, one
     final reply a stream, both replicas on version 1. Each replica's
     decode launches (its own thread's, tapped per engine) on the
     vector / stream kernels (rows 1-3: "router_launches"). Fault C7's
     check runs with phase 2: two threads launching rows 2-3 at decode
     on one stream, each output held to its own plain version;
 14. wide&deep (item 21, no kernel of the port on this path: lookups,
     matrix products and the dense Adam are PyTorch's) —
     widedeep_parity: the tiny config, 3 Adam steps on the card against
     the same on the CPU: losses, parameters and both moments within
     1e-4 relative (+ 1e-6); widedeep_phase: bench.py's bench_widedeep
     headline whole (1,048,576-row hashed vocab, 26 slots, embed 16, 13
     dense features, hidden 400-400-400, batch 4096, f32, Adam 1e-3,
     numpy inputs each step), 3 warm-up + 20 timed steps: examples/s,
     median step ms (CUDA events), the same on inputs resident on the
     card, peak memory allocated and requested, the loss finite and
     falling, 0 port launches;
 15. data parallelism (item 14(a)), two ranks started by
     the port's distributed.spawn on the one card over gloo (NCCL
     refuses two ranks on one GPU), each loading the kernels the parent
     built (a build inside a rank fails): bert_dp — bench_bert's
     configuration through TrainStep(mesh=make_mesh({"dp": 2})), each
     rank on 8 of the global 16 sequences, 1 + 4 steps at dropout 0
     (losses within 1e-3 relative of a dp = 1 run on the card, same
     weights and global batch) and at dropout 0.1 (step ms, global
     samples/s beside phase 8's dp = 1 figure, each rank's peak memory,
     the gradient all-reduce's share of the step, the card drained
     around it; rows 2-5 and 8-9 launched on both ranks, as often on
     each, their counts added to the kernels line as
     "bert_dp_launches"); dp_parity — a conv-BN net (3 momentum steps:
     losses, parameters, running statistics within 1e-4 + 1e-4
     relative) and the static regression program of
     tests/test_data_parallel.py through CompiledProgram
     .with_data_parallel (20 steps, losses within 2e-3 relative), dp = 2
     against dp = 1 on the card; allreduce — bench.py's bench_allreduce
     over the dp group (64 MB f32, 5 + 30 calls, algorithmic bandwidth
     2 (n - 1) / n bytes / time), a gloo host-path figure, not NCCL's;
 16. hybrid_gpt (item 14(b)): the hybrid GPT step over a world of
     ranks on the one card (gloo; p2p through host copies), each rank
     reading its pieces of one weight tree the parent wrote once
     (np.save, read back as memmaps). (a) GPT-3 XL cut to its first
     MESH_A_LAYERS = 4 layers at full width (the time limit: see
     HYBRID_STEPS) at pp = 2 x tp = 2 (4 ranks), bf16, flash,
     remat, dropout 0,
     global batch 4 x 1024, 4 microbatches, 1F1B then F-then-B, 1 + 1
     steps each: every loss within 1e-3 relative of the single-rank
     step's on the same batch and weights; (b) 4 layers at full width,
     dp = 2 x pp = 2 x tp = 2 (8 ranks), ZeRO-1, batch 8 x 1024: at
     dropout 0 the losses within 1e-3 of the single rank's, then one
     step at dropout 0.1 under 1F1B, finite and equal on every rank;
     each rank's moment
     bytes 1/dp of the unsharded layout's. Printed: step ms, tokens/s,
     each rank's peak memory, the ms a step in tp all-reduces and in pp
     send / recv, the measured bubble (pp receive wait over the
     schedule) against (S - 1) / (M + S - 1), and the launches of rows
     2-5 and 8-9 on each rank by route (rows 2-5 all tc, in the counts
     mesh_launches predicts); with phase 2 the kernels at the shapes
     this path gives them (check_hybrid_kernels: the partial sub-blocks
     at K = 1024 / I = 4096 bf16, flash at 8 heads, layer norm at
     R = 1024, C = 2048 bf16);
 17. sp_gpt (item 14(c)): ring attention over the sp axis, on the same
     weight tree as phase 16: (a) GPT-3 XL's first MESH_A_LAYERS
     layers at sp = 2 (2 ranks), bf16, remat, dropout 0, global batch
     2 x 2048 (a rank's half of each sequence); (b) 4 layers at dp = 2
     x pp = 2 x sp = 2 (8 ranks) under 1F1B, 2 microbatches, batch 8 x
     1024, then one step at dropout 0.1 (finite and equal on every
     rank); 1 + 1 steps each,
     every loss within 1e-3 relative of the single rank's (attn_impl
     "xla", the reference test's comparison) on the same weights and
     batch. Printed: step ms, tokens/s, each rank's peak memory, the ms
     a step in ring hops and in the sp / dp gradient sum, and each
     rank's launches of rows 2-5 and 8-9 against mesh_launches (rows
     2-3 on tc; no flash, the ring replaces it; no row 8-9 at tp = 1);
 18. moe_gpt: GPT-2 small widths (12 layers, d 768, 12 heads, vocab
     50304) with Switch-Base-8's 8 experts, top-1, capacity factor
     1.25, flash, remat, at dp = 2 x ep = 2 x tp = 2 (8 ranks), global
     batch 8 x 1024, weights and batch from seed 0, 1 + 1 steps, once
     in bf16 and once in f32, each against the single rank in the same
     dtype: the first step's gradients (the same weights, no update)
     on every rank, the clip's global norm and the router's wg, within
     1e-5 relative in f32 and 5e-3 / 0.1 in bf16; the first loss (one
     forward) within 1e-5 (f32) / 1e-3 (bf16), the later ones within
     1e-3 / 1.5e-2 (Adam's first updates grow rounding about tenfold a
     step; bf16's own trajectory and gradients against f32's on one
     rank alone printed beside); each rank's split expert bytes
     1/(ep tp) of the bank's; the share of layer 0's tokens routed to another expert
     than on the single rank and dropped at capacity; step ms, the ms
     in ep and tp all-reduces; rows 4-5 launched on tc (bf16) / simt
     (f32) in mesh_launches' counts on every rank;
 19. widedeep_mp: phase 14's headline wide&deep at dp = 2 x mp = 2 (4
     ranks; both tables row-sharded over mp, the collective lookup),
     batch 4096, 1 + 5 Adam steps: losses within 5e-4 of the single
     rank's (the reference test's bound), each rank's table bytes 1/mp
     of the whole; examples/s beside phase 14's, the ms a step in the
     lookup's all-reduce and in the dp gradient average; with phase 2
     (check_mesh_kernels) rows 2-3 at an sp_gpt rank's shape (M = 2048)
     and rows 4-5 at a moe_gpt rank's (4 x 6 heads of 64);
 19b. elastic (item 16(c)): bench.py's bench_elastic measures at
     bench_bert's configuration (BERT-base widths cut to
     ELASTIC_BERT_LAYERS = 4 layers, global batch 16 x 128, O1, AdamW
     lr 1e-4) at dp 2: tests/torch_elastic_trainer.py under
     ``python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2``,
     both ranks on the one card over gloo (``TrainStep(mesh=make_mesh(
     {"dp": 2}))``, deterministic algorithms, CUBLAS_WORKSPACE_CONFIG
     set in the child before CUDA starts), 8 steps of a seeded corpus of
     512 sequences in SampleSchedule order, an async ClusterCheckpoint
     save every 2 steps ((c) every 4; float32 parameters and Adam slots
     replicated, the cursor per rank), dropout 0: (a) fault-free,
     without saves; (b) rank 1 killed at step 5 (once step 4's version
     has committed), --max_restarts 2, backoff 0.05 s: the gang
     restarts from step 4's version, and every step's loss and every
     final parameter must equal (a)'s bit for bit; (c) rank 1 failing at
     step 5 in every life under --exclude_flapping --flap_threshold 1:
     the job goes on at world 1 from step 4's version, steps 5-7 within
     1e-3 relative of (a)'s world-2 curve, every step's record showing
     the world. Every rank and life: on the card, gloo where two ranks
     run, no kernel built in the child, rows 2-5 and 8-9 launched
     bert_launches(4) times a step it ran, flash on tc, the
     sub-blocks on ffma, layer norm on warp. Printed: each run's
     launcher lines, losses, worlds, step ms, its lives (each with its
     start: process start to its first step), detect -> resume seconds
     (the largest gap between two step records, and the kill to the
     first resumed record), the restore's seconds
     (paddle_tpu_elastic_resume_seconds) and the upload's, rank 0's
     save host-copy, part-write and merge seconds and the checkpoint's
     GB; then bench_elastic's save overhead on the card
     (a 512-wide tanh MLP, 120 steps, a save every 30: async and sync
     against no save, beside its 5% bar). Every job runs in a session
     of its own, killed whole on the way out;
 20. widedeep_ps_parity (item 16(a), the parameter-server tier; no
     kernel of the port on this path: the workers' products and the
     dense gradients are PyTorch's, the shards' tables host numpy behind
     the C++ core): WideDeepConfig.tiny() with a local-mode FleetWrapper
     (in-process tables on the native core), lr 0.1, the batches of
     tests/test_fleet_wrapper.py: a DownpourWorker on the card and one on
     the CPU, 20 batches from seed 0, every loss and every table pulled
     back afterwards within rtol 1e-4 / atol 1e-6; then one
     HeterDenseWorker step on the card against the CPU (loss, d_emb,
     d_wide and the updated parameters, same tolerance);
 21. widedeep_ps: bench.py's bench_widedeep_ps_tcp whole (steps 8,
     warm-up 1): 2 port PSServer processes and 2 DownpourWorker
     processes on the one card over localhost TCP
     (paddle_tpu_torch.distributed.fleet.ps_roles), WideDeepConfig()
     (1,048,576 hashed vocab, 26 slots, embed 16, 13 dense, hidden
     400-400-400), batch 4096 of Zipf(1.3) ids from RandomState(7 +
     worker), lr 0.05, worker 0 seeding the dense tables; then the same
     through the BoxPS cache (capacity 1 << 21, flush every 8). The
     workers meet at a fetch barrier before their timed windows. Each
     mode: examples/s of both workers (every timed example over the
     first start to the last end) and the share of that span in which
     both windows were open, wire MB out and in per worker step
     (PSClient byte counters), each worker's median pull / local-step
     (CUDA events: uploads, forward, backward, gradients to the host) /
     push / step ms, the card's busy ms in one step (torch.profiler,
     that worker's kernels and copies) and its share of the median
     step, peak memory and losses, each shard's table sizes and its
     native core (its ready line). Gates: losses finite, wire bytes
     non-zero, 0 port launches, every shard on its native core, workers
     on the card;
 22. heter_ps: a HeterDenseWorker on the card (this process) behind 1,
     then 2, HeterCpuWorker processes over one port PSServer process,
     WideDeepConfig(), batch 4096, 1 + 8 steps each: examples/s as in
     21, the dense step's ms (CUDA events; with 2 CPU workers a span can
     hold the other worker's step, so the 1-worker run gives the step
     alone), the losses. Gates: losses finite, 0 port launches. Every
     phase 21-24 process has a timeout and is killed in a finally;
 23. widedeep_ps_ha (item 16(b)): one DownpourWorker process on the card
     (WideDeepConfig(), batch 4096 of Zipf(1.3) ids from RandomState(7),
     lr 0.05, 1 + 8 steps, the local step under
     torch.use_deterministic_algorithms with CUBLAS_WORKSPACE_CONFIG
     =:4096:8 set before CUDA starts; it serves every run of phases
     23-24 on one context) over 2 shard groups, each a WAL-on primary
     and one standby process (PADDLE_PS_HA_SEMISYNC=1): two fault-free
     runs, one over async pairs, then a chaos run in which shard 0's
     primary dies after a commit and before its reply
     (PADDLE_PS_FAULT_KILL_AFTER / _KILL_POINT=reply, at half the
     requests that primary received in the first fault-free run; the
     row gives the push it cut) and ps_ha.promote_best promotes its
     standby at epoch 2, as bench_ps_ha does. Printed: kill -> first
     successful push seconds, the standbys' lag in records (mean, max,
     sampled every 20 ms) and the drain seconds of the fault-free and
     async runs, the push p50 of a step in semi-sync against async,
     examples/s and pull / local-step / push ms of each run. Gates:
     the primary died and its standby was promoted, the worker failed
     over, the chaos run's and the async run's losses and tables
     (every touched row of embed and wide, every dense table, pulled
     back) bit-equal to the first fault-free run's (if the two
     fault-free runs differ, both are held to that spread and it is
     printed), workers on the card, 0 port launches;
 24. ps_tiered (item 16(b)): (a) bench.py's bench_tiered whole on the
     port (a WAL-on shard in this process, every table tiered under a
     256 KiB warm budget, 2^26-row vocab, dim 8, batch 256, Zipf(1.2),
     400 train + 400 serving steps): serving pull p50 / p99 ms, train
     examples/s, warm hit rate, warm / cold rows, demotions (clean /
     flush), warm bytes after a drain; gates: warm bytes within the
     budget, no failed cold read. (b) phase 23's worker over 2 shards
     (numpy tables), once all-warm and once with embed tiered
     (PADDLE_PS_TIER_TABLES=embed) under 1/8 of the embed bytes the
     all-warm run left on each shard: examples/s, pull ms and cold
     faults of both; gates: losses and tables bit-equal (phase 23's
     rule), cold faults and demotions > 0, no failed cold read;
 25. the kernels line, then the card line, then the result line.

Each phase prints its wall seconds ({"phase": "seconds", ...}). Phases
15-19 run their ranks in three worlds, one a size (world_phases: 2
ranks for 15 and 17 (a), 4 for 16 (a) and 19, 8 for 16 (b), 17 (b) and
18), so a rank's start and warm-up are paid once a world; each such
phase's seconds are its single-rank references and its report, and each
world prints its own ({"phase": "spawn", ...}: each rank's start, its
process group and the end of each phase's cases). One
numpy weight tree (seed 0, 1.3 B parameters, drawn on a thread while
the kernels build) feeds phases 3-5; the
BERT phases draw their weights from the port's seeded initialisers.
Any failed phase exits non-zero before the result line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# Data-sheet rates of the H100 SXM (NVIDIA): f32 outside the tensor
# cores, bf16 dense tensor cores, HBM3. The port computes f32 with TF32
# off; a kernel's bound uses the peak of its input type.
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

PAGED_SRC = "paddle_tpu_torch/ops/csrc/paged_attention.cu"
BLOCK_SRC = "paddle_tpu_torch/ops/csrc/fused_block.cu"
FLASH_SRC = "paddle_tpu_torch/ops/csrc/flash_attention.cu"
LN_SRC = "paddle_tpu_torch/ops/csrc/layer_norm.cu"
DAL_SRC = "paddle_tpu_torch/ops/csrc/fused_residual.cu"
FFN_SRC = "paddle_tpu_torch/ops/csrc/fused_ffn.cu"
SOURCE = {"fused_ffn": FFN_SRC, "paged_attention": PAGED_SRC, "fused_out_ln": BLOCK_SRC,
          "fused_ffn_ln": BLOCK_SRC, "flash_fwd": FLASH_SRC,
          "flash_bwd_dq": FLASH_SRC, "flash_bwd_dkv": FLASH_SRC,
          "layer_norm_fwd": LN_SRC, "layer_norm_bwd_dx": LN_SRC,
          "dropout_add_ln_fwd": DAL_SRC, "dropout_add_ln_bwd": DAL_SRC}
REPLACES = {
    "paged_attention": "paddle_tpu/ops/paged_attention.py:76 _paged_kernel "
                       "(paged_attention_pallas :114)",
    "fused_out_ln": "paddle_tpu/ops/pallas_block.py:152 _out_ln_kernel "
                    "(_out_ln_pallas :179)",
    "fused_ffn_ln": "paddle_tpu/ops/pallas_block.py:321 _ffn_ln_kernel "
                    "(_ffn_ln_pallas :358)",
    "flash_fwd": "paddle_tpu/ops/pallas_attention.py:127 _fwd_kernel "
                 "(_flash_fwd_impl :288, pallas_call :316)",
    "flash_bwd_dq": "paddle_tpu/ops/pallas_attention.py:185 _bwd_dq_kernel "
                    "(_flash_bwd :337, pallas_call :375)",
    "flash_bwd_dkv": "paddle_tpu/ops/pallas_attention.py:222 "
                     "_bwd_dkv_kernel (_flash_bwd :337, pallas_call :410)",
    "layer_norm_fwd": "paddle_tpu/ops/pallas_layer_norm.py:51 _fwd_kernel "
                      "(_ln_fwd_impl :87, pallas_call :90)",
    "layer_norm_bwd_dx": "paddle_tpu/ops/pallas_layer_norm.py:66 "
                         "_bwd_dx_kernel (_ln_bwd :117, pallas_call :124)",
    "dropout_add_ln_fwd": "paddle_tpu/ops/pallas_fused_residual.py:68 "
                          "_fwd_kernel (_fwd_impl :133, pallas_call :136)",
    "dropout_add_ln_bwd": "paddle_tpu/ops/pallas_fused_residual.py:91 "
                          "_bwd_kernel (_vjp_bwd :169, pallas_call :175)",
    "fused_ffn": "paddle_tpu/ops/pallas_ffn.py:124 _ffn_kernel "
                 "(_ffn_fwd_impl :143, pallas_call :148)",
}
# the two routes of the flash kernels (ops/flash_attention.py
# flash_tc_route)
FLASH_DESIGN = {
    "tc": "tensor cores: wgmma bf16 (f32 sums) fed by TMA through 3-D "
          "tensor maps, 2 warpgroups of 64 output rows each (256 threads, "
          "255 registers a thread), thread 0 feeding a 2-4 stage ring; "
          "fwd: K/V tiles of 128, P rounded to bf16 in registers as the A "
          "operand of P V (a pre-pass of Q K^T for the row max where the "
          "reference's key block is wider than the tile); dq: K/V tiles of "
          "64, dS in registers; dkv: S^T = K Q^T over Q tiles of 64, P^T "
          "and dS^T in registers as A of dV and dK; mask, lse and delta "
          "slices ride in the stages by bulk copy",
    "simt": "SIMT f32 FMA on the CUDA cores, 64 x 64 tiles (32 x 32 at D > "
            "128) in f32 shared memory, 256 threads as a 16 x 16 grid; bf16 "
            "rounds P against a pre-pass row max per reference block"}
# the four routes of the sub-block kernels (ops/fused_block.py tc_route,
# ffma_route, stream_route)
DESIGN = {
    "tc": "tensor cores: wgmma m64n128k16 bf16 (f32 sums) on a 6-stage "
          "ring of 128B-swizzled tiles filled by TMA, 1 producer thread + 2 "
          "consumer warpgroups, 128x128 output tiles, no split over K, one "
          "persistent block an SM; fused_ffn_ln passes hid through device "
          "memory in bf16 (two product launches); the LN is a row-kernel "
          "launch",
    "ffma": "f32 FFMA on the CUDA cores (f32 at M >= 128): register-tiled "
            "GEMM of ffma_tile.cuh, 256 threads with 8x8 / 8x4 / 4x4 outputs "
            "each on 128x128 / 128x64 / 64x64 tiles picked per product, a "
            "3-stage cp.async ring of k = 32, no split over K, the epilogue "
            "fused; fused_ffn_ln passes hid through device memory in f32 "
            "(two product launches); the LN is a row-kernel launch",
    "stream": "f32 weight streaming on the CUDA cores (f32, 1 to "
              "_STREAM_MAX_ROWS rows: decode, short prefills; "
              "csrc/stream_gemm.cuh): a block owns 32 columns of W and a K "
              "range (stream_splits: about 2 blocks an SM), a 4-stage ring "
              "of 64-row stages by 16-byte cp.async with A's rows in the "
              "stage, 4/8/16 rows of accumulators a thread, K splits summed "
              "in split order by the last block of a column tile to take "
              "its self-resetting ticket (per-stream workspace), the LN by "
              "the last column tile of a row tile; fused_out_ln one launch, "
              "fused_ffn_ln two with hid in f32 in the workspace",
    "simt": "SIMT f32 register-tiled GEMM on the CUDA cores; split-K "
            "(fused_out_ln) / split-I (fused_ffn_ln) f32 partials summed in "
            "fixed order by the last-arriving block"}
# the three routes of fused_ffn (ops/fused_ffn.py ffn_route)
FFN_DESIGN = {
    "tc": "tensor cores: the sub-blocks' wgmma core (block_gemm.cuh "
          "tc_gemm, 128x128 tiles, one persistent block an SM), two "
          "launches: hid = round(act(x W1 + b1)) in bf16 through device "
          "memory, then y = round(hid W2 + b2) (bias-only epilogue)",
    "ffma": "f32 FFMA on the CUDA cores (f32 at M >= 128): the sub-blocks' "
            "register-tiled core (block_gemm.cuh ffma_gemm), two launches "
            "with hid in f32 through device memory, each product on the "
            "tile ffma_tiles picks",
    "simt": "one launch, hid on chip: a block owns 16 or 32 rows and an H "
            "column tile with its f32 sum in shared memory, walking I in "
            "chunks of 128"}
# the two routes of the layer-norm kernels (ops/layer_norm.py ln_route)
LN_DESIGN = {
    "warp": "a warp owns a row in registers: 16-byte loads (float4 / 8 "
            "bf16) all issued up front, NV vectors a lane (a template "
            "parameter, 32 elements a lane at most: C <= 1024), scale and "
            "bias slices kept for every row the warp takes, two-pass "
            "statistics by xor-butterfly shuffles, no shared memory or "
            "barrier, 16-byte stores; rows a block and blocks from ln_grid",
    "row": "a 64-512-thread block owns a row staged in shared memory as "
           "f32, block sums through shared memory (the first port's "
           "kernel; any C <= 16384, any alignment)"}
# the two routes of the dropout + residual + layer norm kernels, picked
# by the same ln_route over the pointers of a call
DAL_DESIGN = {
    "warp": "a warp owns a row in registers (layer norm's warp frame, "
            "row_norm.cuh): x and res (forward) or z and dy (backward) by "
            "16-byte loads all issued up front, the mask replayed in "
            "registers, two-pass statistics (forward) or both sums in one "
            "pass (backward) by xor-butterfly shuffles, no shared memory "
            "or barrier, 16-byte stores; the forward reads scale and bias "
            "from L1 a row, the backward holds its scale slice; at p = 0 "
            "the backward writes dres alone; rows a block and blocks from "
            "ln_grid",
    "row": "a 64-512-thread block owns a row staged in shared memory as "
           "f32, block sums through shared memory (the first port's "
           "kernels; any C <= 16384, any alignment)"}
# the two routes of paged attention (ops/paged_attention.py paged_route),
# both split over the context: grid (S, H, splits), pages a split from
# paged_splits (table shape and SM count, no host sync), P in f32,
# (m, l, acc) a split merged in split order by the last block of a
# (slot, head) to take its ticket
PAGED_DESIGN = {
    "vector": "K/V rows by 16-byte cp.async through a 4-stage ring of "
              "16-token chunks, 8 lanes a token score 4 tokens a warp (q "
              "f32, pools f32/bf16, d <= 128, aligned and contiguous)",
    "scalar": "plain loads of the pools by their strides, a warp scores "
              "its 4 tokens of a chunk one by one, q and P V in shared "
              "memory (every other call: q and pools f32/bf16/f16, any "
              "d <= 16384, any alignment or strides)"}
# the device functions of ops/csrc, as the profiler names them
PORT_KERNEL_NAMES = ("paged_split_kernel", "paged_scalar_kernel",
                     "out_ln_kernel", "ffn_kernel",
                     "stream_gemm::stream_kernel",
                     "tc_gemm_kernel", "ffma_gemm_kernel", "ln_rows_kernel",
                     "flash_fwd_kernel",
                     "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                     "tc::flash_fwd_tc_kernel", "tc::flash_bwd_dq_tc_kernel",
                     "tc::flash_bwd_dkv_tc_kernel",
                     "ln_fwd_kernel", "ln_bwd_dx_kernel",
                     "ln_fwd_warp_kernel", "ln_bwd_dx_warp_kernel",
                     "dal_fwd_kernel", "dal_bwd_kernel",
                     "dal_fwd_warp_kernel", "dal_bwd_warp_kernel")
SERVING_KERNELS = ("paged_attention", "fused_out_ln", "fused_ffn_ln")
TRAINING_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                    "fused_out_ln", "fused_ffn_ln")
TRAIN_TOKENS = 1024
# the serving run's page pool: pages and their size
SERVE_PAGES, SERVE_PAGE = 256, 16
# bench.py's bench_slo / bench_chaos traffic (_slo_traffic): 6 s of
# diurnal arrivals, seed 7; the offered rate starts at 8 requests/s and
# halves (to no less than 1) while the engine cannot hold it
SLO_DURATION, SLO_SEED, SLO_RATE, SLO_MIN_RATE = 6.0, 7, 8.0, 1.0
# bench_chaos: a 0.8 s stall at serving_decode against a 0.5 s watchdog
# deadline; detection and recovery each within 30 s
CHAOS_STALL_S, CHAOS_DEADLINE_S, CHAOS_WAIT_S = 0.8, 0.5, 30.0
# bench.py's bench_bert: BERT-base, batch 16 x 128, 19 masked positions
BERT_BATCH, BERT_SEQ = 16, 128
BERT_PRED = min(BERT_SEQ, max(8, int(round(BERT_SEQ * 0.15))))
BERT_LAYERS = 12


def bert_launches(layers):
    """Launches of one BERT train step of `layers` layers (no remat; the
    sub-blocks' backward is the composed recompute; LN: embeddings and
    MLM head)."""
    return {"fused_out_ln": layers, "fused_ffn_ln": layers,
            "flash_fwd": layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers, "layer_norm_fwd": 2,
            "layer_norm_bwd_dx": 2}


BERT_LAUNCHES_PER_STEP = bert_launches(BERT_LAYERS)
# the encoder layer with the constructor's defaults, forward + backward
# (rows 6-7 at 2048 x 768 in f32: the warp route)
ENCODER_LAYER_LAUNCHES = {
    "dropout_add_ln_fwd": 1, "dropout_add_ln_bwd": 1,
    "dropout_add_ln_fwd.warp": 1, "dropout_add_ln_bwd.warp": 1,
    "fused_out_ln": 1, "flash_fwd": 1, "flash_bwd_dq": 1,
    "flash_bwd_dkv": 1}
# the static FFN program: ops/autobench.py's bert_base_512 preset shape
FFN_M, FFN_H, FFN_I = 8192, 768, 3072
FFN_STEPS = 5
# fused_ffn launches of one static FFN step: the forward op, and the
# forward re-run inside fused_ffn_grad (the auto grad differentiates the
# op's compute)
FFN_LAUNCHES_PER_STEP = 2
# bench.py's bench_lenet
LENET_BATCH, LENET_STEPS = 256, 30
# data-parallel phases: ranks, all on the one card (gloo: NCCL refuses
# two ranks on one GPU)
DP_RANKS = 2
# hybrid_gpt: (a) GPT-3 XL at pp x tp, (b) B_LAYERS at dp x pp x tp with
# ZeRO-1; the global batches; microbatches; 1 + 1 steps a run (the
# second loss is the first update's), (b)'s dropout run 1. These, sp_gpt
# (a)'s depth and moe_gpt's steps are cut to fit the time limit: at 12
# layers and 1 + 2 steps the whole script took 994 s on one H100 (hybrid_gpt
# 136, sp_gpt 109, moe_gpt 98 s) and more than its 1,200 s on another
HYBRID_A = dict(pp=2, tp=2)
HYBRID_B = dict(dp=2, pp=2, tp=2)
HYBRID_A_BATCH, HYBRID_B_BATCH, HYBRID_MICRO, HYBRID_STEPS = 4, 8, 4, 2
HYBRID_A_STEPS = 2
MESH_A_LAYERS = 4
HYBRID_B_LAYERS = 4
HYBRID_CFG = dict(amp_dtype="bfloat16", attn_impl="flash", remat=True)
# the losses against the single rank's: tighter than phase 4's 2e-2, so
# that a split fault shows. Sound splits read at most 3.25e-4 (H100,
# 700 W), and a step moves GPT-3 XL's loss by 0.3-0.7, so a wrong tp or
# stage-pair sum, which changes the update, moves the later losses
HYBRID_RTOL = 1e-3


# sp_gpt (item 14(c)): (a) GPT-3 XL's first MESH_A_LAYERS layers at
# sp 2, batch 2 x 2048; (b)
# HYBRID_B_LAYERS at dp 2 x pp 2 x sp 2 under 1F1B, 2 microbatches,
# batch 8 x 1024; the step sets attn_impl "ring", the single rank runs
# "xla" (the reference test's comparison)
SP_A, SP_A_BATCH, SP_A_SEQ = dict(sp=2), 2, 2048
SP_B, SP_B_BATCH = dict(dp=2, pp=2, sp=2, n_microbatches=2), 8
SP_CFG = dict(amp_dtype="bfloat16", remat=True)
# moe_gpt: GPT-2 small widths with Switch-Base-8's 8 experts, top-1,
# capacity factor 1.25, at dp 2 x ep 2 x tp 2, batch 8 x 1024
MOE_CFG = dict(num_experts=8, moe_top_k=1, moe_capacity_factor=1.25,
               amp_dtype="bfloat16", attn_impl="flash", remat=True)
MOE_MESH, MOE_BATCH = dict(dp=2, ep=2, tp=2), 8
# the first step's gradients (the same weights, before any update)
# against the single rank's: the clip's global norm and the router's
# wg, relative. Sound splits on seeds 0 and 1 read in f32 norm 0, wg
# 7.2e-7; in bf16 norm 1.8e-3, wg 3.6e-2 (H100, 700 W). A router
# gradient counted ep = 2 times is 100% off, a sum missing over 2 ranks
# about half of a part.
MOE_PROBE = ("blocks.wg",)
MOE_PROBE_RTOL = {"bf16": {"norm": 5e-3, "blocks.wg": 0.1},
                  "f32": {"norm": 1e-5, "blocks.wg": 1e-5}}
# the losses against the single rank's, a bound a step: step 1 is one
# forward on the same weights; after it Adam's first updates take the
# sign of each gradient element, so rounding in near-zero elements
# grows about tenfold a step. Sound splits read at step 1 2.1e-4 (bf16)
# and 0 (f32), after it up to 5.04e-3 (bf16) and 2.44e-4 (f32), seeds
# 0 and 1. These hold the update (Adam on the split's gradients) to
# that noise; a wrong scale, which Adam's update hides, is the probe's.
MOE_RTOL = {"bf16": (HYBRID_RTOL, 1.5e-2), "f32": (1e-5, HYBRID_RTOL)}
# widedeep_mp: phase 14's headline config at dp 2 x mp 2, 1 + 5 steps;
# the losses against the single rank's within the reference test's bound
WD_MESH, WD_MP_STEPS, WD_MP_ATOL = dict(dp=2, mp=2), 6, 5e-4


def mesh_launches(layers, pp=1, micro=1, steps=HYBRID_STEPS, kind="tp"):
    """Launches a rank makes of rows 2-5 and 8-9 on a mesh path, n =
    layers a stage x microbatches x steps. "tp" (hybrid_gpt: dense
    blocks at tp > 1): each layer runs, per microbatch, both partial
    sub-blocks, flash forward and LN2 (row 8) twice (forward, then the
    recompute), and the two flash backward kernels and LN2's dx once
    (the sub-blocks' backward is the composed recompute); "sp" (sp_gpt:
    dense blocks at tp = 1 under the ring): both sub-blocks twice, no
    flash (the ring replaces it) and no row 8-9; "moe" (moe_gpt: the
    expert blocks' composed tail): flash as "tp", nothing else."""
    n = layers // pp * micro * steps
    sub, flash, ln = kind in ("tp", "sp"), kind in ("tp", "moe"), \
        kind == "tp"
    return {"fused_out_ln": 2 * n * sub, "fused_ffn_ln": 2 * n * sub,
            "flash_fwd": 2 * n * flash, "flash_bwd_dq": n * flash,
            "flash_bwd_dkv": n * flash, "layer_norm_fwd": 2 * n * ln,
            "layer_norm_bwd_dx": n * ln}


def mesh_routes(want):
    """The route each kernel of mesh_launches takes on the mesh paths:
    rows 2-5 tc (bf16 at widths of multiples of 64), rows 8-9 row (LN2
    after the tp sum at C = 2048, past the warp route's 1024)."""
    return {k: "row" if k.startswith("layer_norm") else "tc" for k in want}


# figures a later phase prints beside its own
MEASURED: dict = {}
# bench.py's bench_resnet50
RESNET_BATCH, RESNET_WARMUP, RESNET_STEPS = 256, 3, 10
# bench.py's bench_widedeep
WD_BATCH, WD_WARMUP, WD_STEPS = 4096, 3, 20
# device work, by name, that changes a tensor's layout, and copies (dtype
# casts among them: torch casts through its direct_copy kernels, whose
# names profile_steps cuts to "...direct_c")
LAYOUT_KERNELS = ("transpose", "Transpose", "nchwToNhwc", "nhwcToNchw")
COPY_KERNELS = ("copy", "Copy", "direct_c")


def timed(name, fn, *args):
    """fn(*args), then one line with the phase's wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(json.dumps({"phase": "seconds", "of": name, "seconds": round(
        time.perf_counter() - t0, 2)}), flush=True)
    return out


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float,
          peak: float = F32_FLOPS) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def within(got, ref, atol: float, rtol: float) -> bool:
    """torch.allclose's criterion, |got - ref| <= atol + rtol |ref|,
    everywhere (NaN fails)."""
    g, r = got.float(), ref.float()
    return bool(((g - r).abs() <= atol + rtol * r.abs()).all())


def report(results, row, ok: bool):
    print(json.dumps(row), flush=True)
    results.append(row)
    if not ok:
        fail(f"{row['kernel']} ({row['shape']}) max abs err "
             f"{row['max_abs_err']} outside tolerance {row['tol']}")


def routed(name, fn, want=None):
    """fn()'s result and the route ("tc", "ffma", "stream", "simt";
    "warp" or "row" for layer norm, "vector" or "scalar" for paged
    attention) that its call of the kernel `name` (a
    sub-block, flash or layer norm) took, read from the per-route
    counters; fails if `want` is given and the route is another."""
    from paddle_tpu_torch.ops import launch_counts
    before = launch_counts()
    out = fn()
    after = launch_counts()
    took = [r for r in design_of(name) if after.get(f"{name}.{r}", 0)
            > before.get(f"{name}.{r}", 0)]
    if len(took) != 1:
        fail(f"{name}: one call took routes {took}")
    if want is not None and took[0] != want:
        fail(f"{name}: took the {took[0]} route, expected {want}")
    return out, took[0]


class Timer:
    """Median CUDA-event time of fn() in ms; a 128 MB write between
    launches evicts the 50 MB L2, as the layers in between would."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(32 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, reps: int = 15, warm: int = 2) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def queued(self, fns, reps: int = 5) -> float:
        """Median device time per call, in ms, of the calls in `fns` run
        back to back. For kernels of a few microseconds the wrapper's
        host time (allocations, ctypes) is longer than the kernel, and
        an event pair around one launch times the host. Here a spin
        kernel holds the stream while the host enqueues every call
        behind it, then the L2 flush, the start event, the calls and the
        end event drain at the device's own pace. A repetition whose
        start event the device reached before the host had queued every
        call (it may have waited on the host) is dropped and the spin
        doubled. Each call works on its own buffers, so after the flush
        every one finds its inputs cold (as far as the sets together
        exceed what L2 would keep)."""
        torch = self.torch
        for fn in fns[:2]:
            fn()
        times, spin = [], 4_000_000
        while len(times) < reps:
            torch.cuda.synchronize()
            torch.cuda._sleep(spin)
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for fn in fns:
                fn()
            e.record()
            starved = s.query()
            e.synchronize()
            if starved and spin < 1 << 30:
                spin *= 2
                continue
            times.append(s.elapsed_time(e) / len(fns))
        return statistics.median(times)


def check_paged(torch, timer, results):
    """B row 1, the split-context kernel, against its plain version at
    S = 8 slots, H = 16 heads of d = 128, pages of 16 (GPT-3 XL decode),
    f32 and bf16 caches, on two ctx mixes: 1 ... 2048 over a 128-page
    table (one slot of each length class, the longest setting the time),
    and the serving run's short contexts (its prompts half-way through
    their decode) over the serving engine's own table width. Each row
    gives the split count from the table's shape (paged_splits), checks
    a bit-identical rerun, and times the kernel, the plain version and
    SDPA over the gathered, masked context (the gather outside the timed
    call) as device time a call (tc_times), beside one call by events
    (call_ms). Each row is held to two plain versions: the split one
    (paged_attention_split_reference at the kernel's pages a split,
    which keeps P in f32 as the kernel does) within 2e-5 for both
    caches (sums in another order), and the gather one (the port of
    the JAX package's paged_attention_xla) within 2e-5 in f32 and 2e-2
    with a bf16 cache (it rounds the probabilities to bf16)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops.fused_block import _sms
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_reference,
        paged_attention_split_reference, paged_splits)
    S, H, d, ps = 8, 16, 128, SERVE_PAGE
    cfg = GPTConfig.gpt3_1p3b()
    serve_m = min(SERVE_PAGES, cfg.max_position_embeddings // SERVE_PAGE)
    mixes = [("ctx<=2048", 2048 // ps,
              [1, 17, 100, 300, 700, 1200, 1777, 2048]),
             ("ctx=serving mix", serve_m,
              [len(p) + n // 2 for p, n, _ in request_mix(cfg.vocab_size)])]
    g = torch.Generator(device="cuda").manual_seed(0)
    scale = d ** -0.5
    sms = _sms(torch.cuda.current_device())
    for label, M, ctx_list in mixes:
        P = S * M
        ctx = torch.tensor(ctx_list, dtype=torch.int32, device="cuda")
        perm = torch.randperm(P, generator=g, device="cuda")
        pt = perm.reshape(S, M).to(torch.int32).contiguous()
        # the trash page (index P) is a valid page: point the tables'
        # unused tails at it, as the engine does
        for s_, c in enumerate(ctx_list):
            pt[s_, -(-c // ps):] = P
        q = torch.randn(S, H, d, generator=g, device="cuda")
        n_tok = sum(ctx_list)
        pps = paged_splits(S, H, M, sms)
        for name, dt, gather_tol in (("f32", torch.float32, 2e-5),
                                     ("bf16", torch.bfloat16, 2e-2)):
            k = torch.randn(P + 1, ps, H, d, generator=g,
                            device="cuda").to(dt)
            v = torch.randn(P + 1, ps, H, d, generator=g,
                            device="cuda").to(dt)
            args = (q, k, v, pt, ctx, scale)
            got, took = routed("paged_attention",
                               lambda: paged_attention_decode(*args),
                               "vector")
            again = paged_attention_decode(*args)
            ref = paged_attention_split_reference(q, k, v, pt, ctx, pps,
                                                  scale)
            gather = paged_attention_reference(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"paged_attention {label} {name}: two runs differ")
            err, gather_err = max_err(got, ref), max_err(got, gather)
            tol = 2e-5
            kd = k[pt.long()].reshape(S, M * ps, H, d).permute(0, 2, 1, 3)
            vd = v[pt.long()].reshape(S, M * ps, H, d).permute(0, 2, 1, 3)
            kd, vd = kd.float().contiguous(), vd.float().contiguous()
            mask = (torch.arange(M * ps, device="cuda")[None, :]
                    < ctx[:, None])[:, None, None, :]
            qd = q[:, :, None, :]
            item = k.element_size()
            nbytes = q.numel() * 4 * 2 + 2 * n_tok * H * d * item \
                + pt.numel() * 4 + S * 4
            bms, by = bound(nbytes, 4 * n_tok * H * d)

            def sdpa(qd, kd, vd, mask, scale):
                return F.scaled_dot_product_attention(
                    qd, kd, vd, attn_mask=mask, scale=scale)

            extra = {"split_ms": split_ms(torch, timer, args, pps)} \
                if label == "ctx<=2048" else {}
            row = {"kernel": "paged_attention",
                   "shape": f"S={S} H={H} d={d} ps={ps} M={M} {label} "
                            f"cache={name}", "route": took,
                   "pages_per_split": pps, "splits": -(-M // pps),
                   "max_abs_err": err, "tol": tol,
                   "gather_err": gather_err, "gather_tol": gather_tol,
                   "bit_identical_rerun": True,
                   **tc_times(torch, timer, args, paged_attention_decode,
                              paged_attention_reference, sdpa,
                              library_args=(qd, kd, vd, mask, scale)),
                   "bound_ms": bms, "bound_by": by, **extra}
            report(results, row, err <= tol)
            if gather_err > gather_tol:
                fail(f"paged_attention ({row['shape']}) max abs err "
                     f"{gather_err} from the gather plain version, outside "
                     f"{gather_tol}")
            del k, v, kd, vd
            torch.cuda.empty_cache()


def check_paged_scalar(torch, timer, results):
    """B row 1's scalar route at the shape of the d = 256 serving run
    (serving_wide_heads_phase: S = 4 slots, H = 2 heads of d = 256, pages
    of 16, its 32-page table, contexts of its first four requests half-way
    through their decode), q and pools in f32 (the path's) and the
    route's other instantiations and layouts at that shape: bf16 pools;
    q and pools in bf16; in f16; f32 pools 4 bytes off a 16-byte
    boundary. Each call must take the scalar route; each row is held to
    the split plain version (P in f32 as the kernel keeps it) within
    2e-5 (2e-2 where q, and so the output, is bf16 or f16) and to the
    gather one on the same terms (2e-2 unless q and pools are f32), with
    a bit-identical rerun, and timed as check_paged's rows (tc_times;
    each timed copy keeps its tensor's alignment)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.fused_block import _sms
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_reference,
        paged_attention_split_reference, paged_splits)
    S, H, d, ps, M = 4, 2, 256, 16, 32
    ctx_list = [72, 28, 37, 110]
    P = S * M
    f32, bf, f16 = torch.float32, torch.bfloat16, torch.float16
    g = torch.Generator(device="cuda").manual_seed(5)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device="cuda")
    pt = torch.randperm(P, generator=g, device="cuda").reshape(S, M) \
        .to(torch.int32).contiguous()
    for s_, c in enumerate(ctx_list):
        pt[s_, -(-c // ps):] = P
    pps = paged_splits(S, H, M, _sms(torch.cuda.current_device()))
    scale = d ** -0.5
    n_tok = sum(ctx_list)

    def shifted(t, off):
        """A copy of t viewed `off` elements into its storage."""
        buf = torch.empty(t.numel() + off, dtype=t.dtype, device="cuda")
        return buf[off:].view(t.shape).copy_(t)

    def keep_alignment(t):
        return shifted(t, 1) if t.data_ptr() % 16 else t.clone()

    def sdpa(qd, kd, vd, mask, scale):
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                              scale=scale)

    for label, qdt, kvdt, off in (
            ("q=f32 pools=f32 aligned", f32, f32, 0),
            ("q=f32 pools=bf16 aligned", f32, bf, 0),
            ("q=bf16 pools=bf16 aligned", bf, bf, 0),
            ("q=f16 pools=f16 aligned", f16, f16, 0),
            ("q=f32 pools=f32 4 bytes off", f32, f32, 1)):
        q = torch.randn(S, H, d, generator=g, device="cuda").to(qdt)
        k, v = (shifted(torch.randn(P + 1, ps, H, d, generator=g,
                                    device="cuda").to(kvdt), off)
                for _ in range(2))
        args = (q, k, v, pt, ctx, scale)
        got, took = routed("paged_attention",
                           lambda: paged_attention_decode(*args), "scalar")
        again = paged_attention_decode(*args)
        ref = paged_attention_split_reference(q, k, v, pt, ctx, pps, scale)
        gather = paged_attention_reference(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"paged_attention scalar {label}: two runs differ")
        err, gather_err = max_err(got, ref), max_err(got, gather)
        tol = 2e-5 if qdt == f32 else 2e-2
        gather_tol = 2e-5 if qdt == kvdt == f32 else 2e-2
        kd = k[pt.long()].reshape(S, M * ps, H, d).permute(0, 2, 1, 3)
        vd = v[pt.long()].reshape(S, M * ps, H, d).permute(0, 2, 1, 3)
        kd, vd = kd.float().contiguous(), vd.float().contiguous()
        mask = (torch.arange(M * ps, device="cuda")[None, :]
                < ctx[:, None])[:, None, None, :]
        qd = q[:, :, None, :].float()
        nbytes = 2 * q.numel() * q.element_size() \
            + 2 * n_tok * H * d * k.element_size() + pt.numel() * 4 + S * 4
        bms, by = bound(nbytes, 4 * n_tok * H * d)
        row = {"kernel": "paged_attention",
               "shape": f"S={S} H={H} d={d} ps={ps} M={M} scalar {label}",
               "route": took, "pages_per_split": pps,
               "splits": -(-M // pps), "max_abs_err": err, "tol": tol,
               "gather_err": gather_err, "gather_tol": gather_tol,
               "bit_identical_rerun": True,
               **tc_times(torch, timer, args, paged_attention_decode,
                          paged_attention_reference, sdpa,
                          library_args=(qd, kd, vd, mask, scale),
                          clone=keep_alignment),
               "bound_ms": bms, "bound_by": by}
        report(results, row, err <= tol)
        if gather_err > gather_tol:
            fail(f"paged_attention ({row['shape']}) max abs err "
                 f"{gather_err} from the gather plain version, outside "
                 f"{gather_tol}")


def split_ms(torch, timer, args, rule):
    """Device time a call (Timer.queued, 8 copies of the pools) of the
    paged-attention kernel pair at several pages a split, through the C
    entry point with the split given, beside the pick of
    ops/paged_attention.py paged_splits ("rule"): on `args` (ctx 1 ...
    2048: the longest slot sets the time) and, under "full", with every
    slot's table full (a fresh permutation of the pool, ctx = M * ps):
    the evidence for the rule. Keys: pages a split."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    q, k, v, pt, ctx, scale = args
    S, H, d = q.shape
    ps, M = k.shape[1], pt.shape[1]
    fn = _build.function("paged_attention", "paged_attention_launch", 8, 6,
                         (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
    stream = torch.cuda.current_stream().cuda_stream
    tickets = torch.zeros(S * H, dtype=torch.int32, device="cuda")
    bf = int(k.dtype == torch.bfloat16)
    pools = [(k.clone(), v.clone()) for _ in range(8)]
    full_pt = torch.randperm(S * M, device="cuda").reshape(S, M) \
        .to(torch.int32).contiguous()
    full_ctx = torch.full_like(ctx, M * ps)

    def run(k, v, table, lens, out, part, pps):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), part.data_ptr(),
                 tickets.data_ptr(), S, H, d, ps, M, pps, scale, bf, stream)
        if err:
            fail(f"paged_attention at {pps} pages a split: CUDA error {err}")

    times = {"rule": rule, "full": {}}
    for pps in sorted({2, 4, 8, rule, 16, 32, 43, M}):
        part = torch.empty(S * H * -(-M // pps) * (d + 2), device="cuda")
        outs = [torch.empty_like(q) for _ in pools]
        for table, lens, into in ((pt, ctx, times),
                                  (full_pt, full_ctx, times["full"])):
            into[str(pps)] = timer.queued([
                lambda kv=kv, o=o: run(*kv, table, lens, o, part, pps)
                for kv, o in zip(pools, outs)])
    del pools
    torch.cuda.empty_cache()
    return times


def check_blocks(torch, timer, results):
    """The sub-blocks in f32 at GPT-3 XL width, at decode (M = 8, the
    stream route) and at the 256-row prefill bucket (the FFMA route). At
    decode, beside kernel_ms: the stream kernel's device time a call,
    the SIMT kernel's on misaligned copies (and its error from the plain
    version), the library chain's, split_ms and the stream_max_rows
    sweep."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.fused_block import (
        _FFMA_MIN_ROWS, ffn_ln_reference, fused_ffn_ln, fused_out_ln,
        out_ln_reference)
    D, I = 2048, 8192
    g = torch.Generator(device="cuda").manual_seed(1)

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * s

    w = rn(D, D, s=0.02)
    b = rn(D, s=0.02)
    ln_s = 1.0 + rn(D, s=0.1)
    ln_b = rn(D, s=0.1)
    w1 = rn(D, I, s=0.02)
    b1 = rn(I, s=0.02)
    w2 = rn(I, D, s=0.01)
    b2 = rn(D, s=0.02)
    tol = 1e-4

    def lib_out(a, w, b, res, ln_s, ln_b):
        zz = torch.addmm(b, a, w).add_(res)
        return F.layer_norm(zz, (D,), ln_s, ln_b, 1e-5)

    def lib_ffn(x, w1, b1, w2, b2, res):
        u = F.gelu(torch.addmm(b1, x, w1), approximate="tanh")
        return torch.addmm(b2, u, w2).add_(res)

    for M in (8, 256):
        want = "ffma" if M >= _FFMA_MIN_ROWS else "stream"
        a = rn(M, D)
        res = rn(M, D)
        args = (a, w, b, res, ln_s, ln_b)
        (z, h), route = routed("fused_out_ln", lambda: fused_out_ln(*args),
                               want)
        zr, hr = out_ln_reference(*args)
        torch.cuda.synchronize()
        err = max(float((z - zr).abs().max()), float((h - hr).abs().max()))
        nbytes = 4 * (M * D + D * D + D + M * D + 2 * D + 2 * M * D)
        bms, by = bound(nbytes, 2 * M * D * D + 10 * M * D)
        row = {"kernel": "fused_out_ln", "shape": f"M={M} D={D} f32",
               "route": route, "max_abs_err": err, "tol": tol,
               "kernel_ms": timer(lambda: fused_out_ln(*args)),
               "plain_ms": timer(lambda: out_ln_reference(*args)),
               "library_ms": timer(lambda: lib_out(*args)), "bound_ms": bms,
               "bound_by": by,
               "device_ms": device_ms(torch, timer, fused_out_ln, args)}
        if route == "ffma":
            row["tile_ms"] = ffma_tile_ms(torch, timer, "fused_out_ln", (
                *args, 0.0, 1e-5, 0))
        else:
            row.update(decode_extras(torch, timer, "fused_out_ln", args,
                                     lib_out, (zr, hr), tol))
        report(results, row, err <= tol)

        x = rn(M, D)
        fargs = (x, w1, b1, w2, b2, res)
        out, route = routed("fused_ffn_ln", lambda: fused_ffn_ln(*fargs),
                            want)
        ref = ffn_ln_reference(*fargs)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        nbytes = 4 * (M * D + D * I + I + I * D + D + M * D + M * D)
        bms, by = bound(nbytes, 4 * M * D * I + 10 * M * I)
        row = {"kernel": "fused_ffn_ln", "shape": f"M={M} H={D} I={I} f32",
               "route": route, "max_abs_err": err, "tol": tol,
               "kernel_ms": timer(lambda: fused_ffn_ln(*fargs)),
               "plain_ms": timer(lambda: ffn_ln_reference(*fargs)),
               "library_ms": timer(lambda: lib_ffn(*fargs)), "bound_ms": bms,
               "bound_by": by,
               "device_ms": device_ms(torch, timer, fused_ffn_ln, fargs)}
        if route == "ffma":
            row["tile_ms"] = ffma_tile_ms(torch, timer, "fused_ffn_ln", (
                *fargs, ln_s, ln_b, "gelu_tanh", "none", 0.0, 1e-5, 0))
        else:
            row.update(decode_extras(torch, timer, "fused_ffn_ln", fargs,
                                     lib_ffn, (ref,), tol))
        report(results, row, err <= tol)
    stream_max_rows_sweep(torch, timer, (w, b, ln_s, ln_b, w1, b1, w2, b2),
                          tol)


def decode_extras(torch, timer, name, args, library, ref, tol):
    """At decode: the SIMT kernel's device time a call on misaligned
    copies of `args` (the route it must take there) and its error from
    the plain version's `ref`, which must be within `tol`; the library
    chain's device time; split_ms."""
    from paddle_tpu_torch.ops.fused_block import fused_ffn_ln, fused_out_ln
    fn = fused_out_ln if name == "fused_out_ln" else fused_ffn_ln
    off = tuple(misaligned(t) for t in args)
    got, _ = routed(name, lambda: fn(*off), "simt")
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    err = max(max_err(g_, r_) for g_, r_ in zip(got, ref))
    if err > tol:
        fail(f"{name} SIMT at decode: max abs err {err} outside {tol}")
    return {"simt_device_ms": device_ms(torch, timer, fn, args,
                                        clone=misaligned),
            "simt_max_abs_err": err,
            "library_device_ms": device_ms(torch, timer, library, args),
            "split_ms": stream_split_ms(torch, timer, name, args)}


def stream_launch(torch, name, args, splits):
    """A function that runs the stream route of `name` (fused_out_ln on
    (a, w, b, res, ln_s, ln_b), fused_ffn_ln on (x, w1, b1, w2, b2, res)
    with gelu_tanh, no norm, no dropout) through its C entry point at
    the K splits given (one count, or one a product), at any row count,
    on its own scratch; returns its outputs. Not counted: it is the
    evidence for stream_splits and _STREAM_MAX_ROWS, not the path."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    tail = (ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_void_p)
    m = args[0].shape[0]
    n_max = max(t.shape[1] for t in args[:4] if t.dim() == 2)
    # partials, then the LN's (mean, M2) pairs
    part = torch.empty((max(splits) + 1) * m * n_max, device="cuda")
    tickets = torch.zeros(-(-m // 4) * (n_max // 32 + 1), device="cuda",
                          dtype=torch.int32)
    stream = torch.cuda.current_stream().cuda_stream

    def check(err):
        if err:
            fail(f"{name} stream launch at splits {splits}: CUDA error "
                 f"{err}")

    if name == "fused_out_ln":
        a, w, b, res, ls, lb = args
        z, h = torch.empty_like(res), torch.empty_like(res)
        fn = _build.function("fused_block", "fused_out_ln_stream_launch", 10,
                             6, tail)
        ptrs = [t.data_ptr() for t in (a, w, b, res, ls, lb, z, h, part,
                                       tickets)]

        def run():
            check(fn(*ptrs, m, a.shape[1], w.shape[1], splits[0], 0, 0, 0,
                     1.0, 1e-5, stream))
            return z, h
        return run
    x, w1, b1, w2, b2, res = args
    hd, i = w1.shape
    out, hid = torch.empty_like(res), torch.empty((m, i), device="cuda")
    fn = _build.function("fused_block", "fused_ffn_ln_stream_launch", 13, 9,
                         tail)
    ptrs = [t.data_ptr() for t in (x, w1, b1, w2, b2, res)]

    def run():
        check(fn(*ptrs, None, None, out.data_ptr(), None, hid.data_ptr(),
                 part.data_ptr(), tickets.data_ptr(), m, hd, i, *splits, 0,
                 0, 0, 0, 0, 1.0, 1e-5, stream))
        return out
    return run


def stream_split_ms(torch, timer, name, args, n_sets=8):
    """Device time a call (Timer.queued, n_sets copies of the tensors) of
    the stream route at several K splits through its C entry point,
    beside ops/fused_block.py stream_splits' pick ("rule"): fused_out_ln
    at 1 ... 16 splits; fused_ffn_ln at each product's neighbours of its
    pick, the other product at its pick (keys "up/down")."""
    from paddle_tpu_torch.ops.fused_block import _sms, stream_splits
    sms = _sms(torch.cuda.current_device())
    m = args[0].shape[0]
    sets = [tuple(t.clone() for t in args) for _ in range(n_sets)]
    if name == "fused_out_ln":
        k, n = args[1].shape
        rule = stream_splits(m, k, n, sms)
        cands = [(s,) for s in sorted({1, 2, 4, 8, 16, rule})]
        times = {"rule": str(rule)}
    else:
        hd, i = args[1].shape
        r1, r2 = stream_splits(m, hd, i, sms), stream_splits(m, i, hd, sms)
        cands = sorted({(s, r2) for s in (1, 2, 4, r1, 2 * r1)}
                       | {(r1, s) for s in (1, 2, 8, 16, r2, 2 * r2)})
        times = {"rule": f"{r1}/{r2}"}
    for c in cands:
        runs = [stream_launch(torch, name, st, c) for st in sets]
        times["/".join(map(str, c))] = timer.queued(runs)
    del sets
    torch.cuda.empty_cache()
    return times


def stream_max_rows_sweep(torch, timer, weights, tol, n_sets=8):
    """The evidence for _STREAM_MAX_ROWS: at 16, 32, 64 and 127 rows of
    GPT-3 XL width in f32, device time a call (Timer.queued, n_sets
    copies) of the stream route (its C entry point at stream_splits'
    pick, whatever the rule says of the rows) and of the SIMT kernel
    (the wrapper on misaligned copies), each call checked against the
    plain version within `tol`. One line a row count and sub-block."""
    from paddle_tpu_torch.ops.fused_block import (
        _STREAM_MAX_ROWS, _sms, ffn_ln_reference, fused_ffn_ln, fused_out_ln,
        out_ln_reference, stream_splits)
    w, b, ln_s, ln_b, w1, b1, w2, b2 = weights
    D, I = w1.shape
    sms = _sms(torch.cuda.current_device())
    g = torch.Generator(device="cuda").manual_seed(5)
    for M in (16, 32, 64, 127):
        a = torch.randn(M, D, generator=g, device="cuda")
        res = torch.randn(M, D, generator=g, device="cuda")
        for name, args, fn, plain, splits in (
                ("fused_out_ln", (a, w, b, res, ln_s, ln_b), fused_out_ln,
                 out_ln_reference, (stream_splits(M, D, D, sms),)),
                ("fused_ffn_ln", (a, w1, b1, w2, b2, res), fused_ffn_ln,
                 ffn_ln_reference, (stream_splits(M, D, I, sms),
                                    stream_splits(M, I, D, sms)))):
            ref = plain(*args)
            ref = ref if isinstance(ref, tuple) else (ref,)
            got = stream_launch(torch, name, args, splits)()
            got = got if isinstance(got, tuple) else (got,)
            off = tuple(misaligned(t) for t in args)
            simt, _ = routed(name, lambda: fn(*off), "simt")
            simt = simt if isinstance(simt, tuple) else (simt,)
            torch.cuda.synchronize()
            err = max(max_err(x, r) for x, r in zip(got, ref))
            simt_err = max(max_err(x, r) for x, r in zip(simt, ref))
            sets = [tuple(t.clone() for t in args) for _ in range(n_sets)]
            line = {"sweep": "stream_max_rows", "kernel": name, "M": M,
                    "rule_max_rows": _STREAM_MAX_ROWS,
                    "splits": "/".join(map(str, splits)),
                    "stream_ms": timer.queued([
                        stream_launch(torch, name, st, splits)
                        for st in sets]),
                    "simt_ms": device_ms(torch, timer, fn, args,
                                         clone=misaligned),
                    "stream_err": err, "simt_err": simt_err, "tol": tol}
            print(json.dumps(line), flush=True)
            del sets
            torch.cuda.empty_cache()
            if max(err, simt_err) > tol:
                fail(f"{name} at M={M}: stream err {err}, SIMT err "
                     f"{simt_err}, outside {tol}")


def ffma_tile_ms(torch, timer, name, args):
    """The FFMA route's time (one launch between events, CUDA events) of
    the call `name`(*args) on each output tile, and for fused_ffn_ln and
    fused_ffn on each pair of tiles of their two products, through the C
    entry point with the tile given: the evidence for
    ops/fused_block.py ffma_tiles' rule, whose pick is under "rule".
    Keys "128x64" or "128x128/64x64"."""
    import ctypes
    import itertools
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops._launch import _drop_args
    from paddle_tpu_torch.ops.fused_block import (
        _FFMA_TILES, _act_norm, _sms, ffma_tiles)
    tail = (ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_void_p)
    stream = torch.cuda.current_stream().cuda_stream
    label = [f"{r}x{c}" for r, c in _FFMA_TILES]
    sms = _sms(torch.cuda.current_device())

    def run(fn, *a):
        err = fn(*a, stream)
        if err:
            fail(f"{name} FFMA launch on a forced tile: CUDA error {err}")

    if name == "fused_ffn":
        x, w1, b1, w2, b2, act = args
        m, hd, i = x.shape[0], x.shape[1], w1.shape[1]
        y, hid = torch.empty_like(x), torch.empty((m, i), device=x.device)
        fn = _build.function("fused_ffn", "fused_ffn_ffma_launch", 7, 6,
                             (ctypes.c_void_p,))
        ptrs = [t.data_ptr() for t in (x, w1, b1, w2, b2, y, hid)]
        code = _act_norm(act, "none")[0]
        times = {f"{label[t1]}/{label[t2]}": timer(lambda t1=t1, t2=t2: run(
            fn, *ptrs, m, hd, i, t1, t2, code))
            for t1, t2 in itertools.product(range(len(label)), repeat=2)}
        times["rule"] = "/".join("x".join(map(str, ffma_tiles(m, c, sms)))
                                 for c in (i, hd))
        return times
    if name == "fused_out_ln":
        a, w, b, res, ls, lb, p, eps, seed = args
        m, k, n = a.shape[0], a.shape[1], w.shape[1]
        z, h = torch.empty_like(res), torch.empty_like(res)
        fn = _build.function("fused_block", "fused_out_ln_ffma_launch", 8, 6,
                             tail)
        ptrs = [t.data_ptr() for t in (a, w, b, res, ls, lb, z, h)]
        times = {label[t]: timer(lambda t=t: run(
            fn, *ptrs, m, k, n, t, *_drop_args(seed, p), eps))
            for t in range(len(label))}
        times["rule"] = "x".join(map(str, ffma_tiles(m, n, sms)))
        return times
    x, w1, b1, w2, b2, res, ls, lb, act, norm, p, eps, seed = args
    m, hd, i = x.shape[0], x.shape[1], w1.shape[1]
    out, hid = torch.empty_like(res), torch.empty((m, i), device=x.device)
    xn, zf = torch.empty_like(x), torch.empty_like(res)
    fn = _build.function("fused_block", "fused_ffn_ln_ffma_launch", 12, 9,
                         tail)
    ptrs = [t.data_ptr() for t in (x, w1, b1, w2, b2, res, ls, lb, out, xn,
                                   hid, zf)]
    codes = _act_norm(act, norm)
    times = {f"{label[t1]}/{label[t2]}": timer(lambda t1=t1, t2=t2: run(
        fn, *ptrs, m, hd, i, t1, t2, *codes, *_drop_args(seed, p), eps))
        for t1, t2 in itertools.product(range(len(label)), repeat=2)}
    times["rule"] = "/".join("x".join(map(str, ffma_tiles(m, c, sms)))
                             for c in (i, hd))
    return times


def device_ms(torch, timer, fn, args, n_sets=8, clone=None):
    """Device time per call of fn(*args) on n_sets copies of the tensors
    (each copied by `clone`, by default Tensor.clone), queued behind
    Timer.queued's spin kernel: the kernels' time without the wrapper's
    host time, which kernel_ms (one call between two events, the device
    idle until the host has launched) includes."""
    clone = clone or (lambda t: t.clone())
    sets = [tuple(clone(t) if torch.is_tensor(t) else t for t in args)
            for _ in range(n_sets)]
    ms = timer.queued([lambda s=s: fn(*s) for s in sets])
    del sets
    torch.cuda.empty_cache()
    return ms


def tc_times(torch, timer, args, kernel, plain, library, n_sets=8,
             library_args=None, clone=None):
    """Times of a kernel row: the kernel, its plain version and the
    library call or chain (on `library_args` where it takes other
    inputs), each called on n_sets copies of its arguments (weights
    included, so every call finds its inputs cold; each tensor copied by
    `clone`, by default Tensor.clone) back to back behind Timer.queued's
    spin kernel: the device time per call. Many kernels run for less
    than their wrapper's host time, which an event pair around one call
    would time instead; that pair is kept as call_ms (host time
    included)."""
    clone = clone or (lambda t: t.clone())

    def copies(a):
        return [tuple(clone(t) if torch.is_tensor(t) else t for t in a)
                for _ in range(n_sets)]

    def each(fn, sets):
        return timer.queued([lambda s=s: fn(*s) for s in sets])

    sets = copies(args)
    times = {"kernel_ms": each(kernel, sets), "plain_ms": each(plain, sets)}
    if library_args is not None:
        del sets
        sets = copies(library_args)
    times["library_ms"] = each(library, sets)
    times["call_ms"] = timer(lambda: kernel(*args))
    del sets
    torch.cuda.empty_cache()
    return times


def check_blocks_bf16(torch, timer, results, M=TRAIN_TOKENS, tag=""):
    """The sub-blocks at the training shape: bf16 activations, weights
    and biases with f32 LN vectors, M = 1024 tokens (or `M`, the shape
    ending in `tag`); both take the tensor-core route there, and each
    row says which route it took.
    Tolerance: both the kernel and the plain version accumulate in f32
    from the same bf16 numbers (hid rounded to bf16 on both sides) and
    round each output once to bf16 (2**-8 relative), so |err| <= 2e-2 +
    2e-2 |ref|. Times: tc_times (device time per call)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.fused_block import (
        ffn_ln_reference, fused_ffn_ln, fused_out_ln, out_ln_reference)
    D, I = 2048, 8192
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(2)

    def rn(*shape, s=1.0, dt=bf):
        return (torch.randn(*shape, generator=g, device="cuda") * s).to(dt)

    w, b = rn(D, D, s=0.02), rn(D, s=0.02)
    ln_s, ln_b = rn(D, s=0.1, dt=torch.float32) + 1.0, \
        rn(D, s=0.1, dt=torch.float32)
    w1, b1 = rn(D, I, s=0.02), rn(I, s=0.02)
    w2, b2 = rn(I, D, s=0.01), rn(D, s=0.02)
    a, res, x = rn(M, D), rn(M, D), rn(M, D)
    tol = {"atol": 2e-2, "rtol": 2e-2}

    (z, h), route = routed("fused_out_ln", lambda: fused_out_ln(
        a, w, b, res, ln_s, ln_b))
    zr, hr = out_ln_reference(a, w, b, res, ln_s, ln_b)
    torch.cuda.synchronize()
    nbytes = 2 * (M * D + D * D + D + M * D + 2 * M * D) + 4 * 2 * D
    bms, by = bound(nbytes, 2 * M * D * D + 10 * M * D, BF16_FLOPS)
    ls16, lb16 = ln_s.to(bf), ln_b.to(bf)

    def lib_out(a, w, b, res, *_):
        zz = torch.addmm(b, a, w).add_(res)
        return F.layer_norm(zz, (D,), ls16, lb16, 1e-5)

    row = {"kernel": "fused_out_ln", "shape": f"M={M} D={D} bf16{tag}",
           "route": route,
           "max_abs_err": max(max_err(z, zr), max_err(h, hr)), "tol": tol,
           **tc_times(torch, timer, (a, w, b, res, ln_s, ln_b),
                      fused_out_ln, out_ln_reference, lib_out),
           "bound_ms": bms, "bound_by": by}
    report(results, row, within(z, zr, **tol) and within(h, hr, **tol))

    out, route = routed("fused_ffn_ln", lambda: fused_ffn_ln(
        x, w1, b1, w2, b2, res))
    ref = ffn_ln_reference(x, w1, b1, w2, b2, res)
    torch.cuda.synchronize()
    nbytes = 2 * (M * D + D * I + I + I * D + D + M * D + M * D)
    bms, by = bound(nbytes, 4 * M * D * I + 10 * M * I, BF16_FLOPS)

    def lib_ffn(x, w1, b1, w2, b2, res):
        u = F.gelu(torch.addmm(b1, x, w1), approximate="tanh")
        return torch.addmm(b2, u, w2).add_(res)

    row = {"kernel": "fused_ffn_ln",
           "shape": f"M={M} H={D} I={I} bf16{tag}",
           "route": route, "max_abs_err": max_err(out, ref), "tol": tol,
           **tc_times(torch, timer, (x, w1, b1, w2, b2, res), fused_ffn_ln,
                      ffn_ln_reference, lib_ffn),
           "bound_ms": bms, "bound_by": by}
    report(results, row, within(out, ref, **tol))


def misaligned(t):
    """A contiguous copy of t 8 bytes past a 16-byte boundary, which
    the tensor-core, FFMA and stream routes do not take."""
    item = t.element_size()
    flat = t.new_empty(t.numel() + 8 // item)
    y = flat[8 // item:].view(t.shape)
    y.copy_(t)
    if y.data_ptr() % 16 != 8:
        fail(f"misaligned: a copy at {y.data_ptr() % 16} bytes off 16")
    return y


def differ(got, ref) -> float:
    """The share of elements that are not the same number."""
    return float((got != ref).float().mean())


def flash_rows(torch, timer, results, q, k, v, do, tail, shape, peak,
               n_el, mbytes, lib_fwd, lib_bwd, extra=None):
    """The three flash kernels on one input set (BH, S|T, D), each
    against its plain version: a row names the route the call took, the
    max abs error, the share of elements that differ from the plain
    version, the times and the bound. Tolerances: f32, |err| <= 1e-4 +
    1e-4 |ref| (sums of up to T terms in another order); bf16, 2e-2 +
    2e-2 |ref| with at most 1% of the elements differing, on the
    tensor-core route (both sides round P, the dropped P and dS to bf16
    where the reference does and sum in f32, in another order); lse is
    f32 in both, 1e-4. Times: bf16
    rows tc_times (device time per call) with one call's event time
    beside it; f32 rows events a call. lib_fwd(q, k, v) and lib_bwd(q,
    k, v, do) are the library yardsticks (SDPA forward; forward +
    backward, the same for both backward rows)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    bh, t, d = k.shape
    item = q.element_size()
    bf16 = q.dtype == torch.bfloat16
    tol = {"atol": 2e-2, "rtol": 2e-2} if bf16 else {"atol": 1e-4,
                                                      "rtol": 1e-4}

    def times(args, kernel, plain, library):
        if bf16:
            return tc_times(torch, timer, args, kernel, plain, library)
        return {"kernel_ms": timer(lambda: kernel(*args)),
                "plain_ms": timer(lambda: plain(*args)),
                "library_ms": timer(lambda: library(*args))}

    def check(name, route, pairs, nbytes, flops, args, kernel, plain,
              library, ok=True):
        bms, by = bound(nbytes, flops, peak)
        share = max(differ(g, r) for g, r in pairs)
        row = {"kernel": name, "shape": shape, "route": route,
               "max_abs_err": max(max_err(g, r) for g, r in pairs),
               "differ": share, "tol": tol,
               **times(args, kernel, plain, library), "bound_ms": bms,
               "bound_by": by, **(extra or {})}
        # every bf16 row here has D = 64 or 128: the tensor-core route
        report(results, row, ok and all(within(g, r, **tol)
                                         for g, r in pairs)
               and (not bf16 or (share <= 0.01 and route == "tc")))

    (o, lse), route = routed("flash_fwd",
                             lambda: fa._fwd_kernel(q, k, v, *tail))
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, *tail)
    torch.cuda.synchronize()
    check("flash_fwd", route, [(o, o_r)],
          item * 4 * bh * t * d + 4 * bh * t + mbytes, 4 * d * n_el,
          (q, k, v), lambda *a: fa._fwd_kernel(*a, *tail),
          lambda *a: fa.flash_fwd_reference(*a, *tail), lib_fwd,
          within(lse, lse_r, 1e-4, 1e-4))

    delta = fa.bwd_delta(o, do)
    args = (q, k, v, do, lse, delta)
    plain_args = (q, k, v, o, lse, do)
    dq, route = routed("flash_bwd_dq", lambda: fa._dq_kernel(*args, *tail))
    dq_r = fa.bwd_dq_reference(*plain_args, *tail)
    torch.cuda.synchronize()
    check("flash_bwd_dq", route, [(dq, dq_r)],
          item * 5 * bh * t * d + 8 * bh * t + mbytes, 6 * d * n_el,
          args, lambda *a: fa._dq_kernel(*a, *tail),
          lambda q, k, v, do, lse, _: fa.bwd_dq_reference(
              q, k, v, o, lse, do, *tail),
          lambda q, k, v, do, *_: lib_bwd(q, k, v, do))

    (dk, dv), route = routed("flash_bwd_dkv",
                             lambda: fa._dkv_kernel(*args, *tail))
    dk_r, dv_r = fa.bwd_dkv_reference(*plain_args, *tail)
    torch.cuda.synchronize()
    check("flash_bwd_dkv", route, [(dk, dk_r), (dv, dv_r)],
          item * 6 * bh * t * d + 8 * bh * t + mbytes, 8 * d * n_el,
          args, lambda *a: fa._dkv_kernel(*a, *tail),
          lambda q, k, v, do, lse, _: fa.bwd_dkv_reference(
              q, k, v, o, lse, do, *tail),
          lambda q, k, v, do, *_: lib_bwd(q, k, v, do))


def sdpa_yardsticks(torch, b, h, **kw):
    """lib_fwd, lib_bwd for flash_rows: one SDPA call on (B, H, T, D)
    views of the same inputs (forward; forward + backward)."""
    import torch.nn.functional as F

    def four(x):
        return x.reshape(b, h, *x.shape[1:])

    def lib_fwd(q, k, v):
        return F.scaled_dot_product_attention(four(q), four(k), four(v),
                                              **kw)

    def lib_bwd(q, k, v, do):
        ql, kl, vl = (four(x).detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, **kw)
        return torch.autograd.grad(out, (ql, kl, vl), four(do))

    return lib_fwd, lib_bwd


def check_flash(torch, timer, results):
    """The three flash kernels at the training shape (B=1, H=16, T=1024,
    D=128, causal) in bf16 (the training path's type: the tensor-core
    route) and f32 (the SIMT route); flash_rows has the tolerances."""
    B, H, T, D = 1, 16, TRAIN_TOKENS, 128
    BH = B * H
    scale = D ** -0.5
    g = torch.Generator(device="cuda").manual_seed(3)
    # score elements the causal kernels need: T (T + 1) / 2 per head
    n_el = BH * T * (T + 1) // 2
    lib_fwd, lib_bwd = sdpa_yardsticks(torch, B, H, is_causal=True)
    for name, dt, peak in (("bf16", torch.bfloat16, BF16_FLOPS),
                           ("f32", torch.float32, F32_FLOPS)):
        q, k, v, do = (torch.randn(BH, T, D, generator=g, device="cuda")
                       .to(dt) for _ in range(4))
        flash_rows(torch, timer, results, q, k, v, do,
                   (scale, True, None, 0, 0.0),
                   f"B={B} H={H} T={T} D={D} causal {name}", peak, n_el, 0,
                   lib_fwd, lib_bwd)


def check_hybrid_kernels(torch, timer, results):
    """The kernels at the shapes the hybrid GPT path gives a tp = 2 rank
    at GPT-3 XL width (M = 1024 tokens a microbatch, bf16): the partial
    out sub-block (a: M x D/tp, wo's rows M: K = 1024, N = 2048, a zero
    residual), the partial FFN sub-block (H = 2048, I = F/tp = 4096, a
    zero residual), the three flash kernels on the rank's 8 heads, and
    LN2 after the tp sum on row 8-9's kernels (R = 1024, C = 2048 > the
    warp route's 1024 columns: the row route). Tolerances as
    check_blocks_bf16, flash_rows and check_rows (bf16: 2e-2 + 2e-2
    |ref|, statistics 1e-4). Each row's shape ends in "(hybrid)"."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import layer_norm as ln
    from paddle_tpu_torch.ops.fused_block import (
        ffn_ln_reference, fused_ffn_ln, fused_out_ln, out_ln_reference)
    M, D, K, I = TRAIN_TOKENS, 2048, 1024, 4096
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(5)

    def rn(*shape, s=1.0, dt=bf):
        return (torch.randn(*shape, generator=g, device="cuda") * s).to(dt)

    w, b = rn(K, D, s=0.02), rn(D, s=0.02)
    ln_s, ln_b = rn(D, s=0.1, dt=torch.float32) + 1.0, \
        rn(D, s=0.1, dt=torch.float32)
    w1, b1 = rn(D, I, s=0.02), rn(I, s=0.02)
    w2, b2 = rn(I, D, s=0.01), rn(D, s=0.02)
    a, x = rn(M, K), rn(M, D)
    zero = torch.zeros(M, D, dtype=bf, device="cuda")
    tol = {"atol": 2e-2, "rtol": 2e-2}

    (z, h), route = routed("fused_out_ln", lambda: fused_out_ln(
        a, w, b, zero, ln_s, ln_b), "tc")
    zr, hr = out_ln_reference(a, w, b, zero, ln_s, ln_b)
    torch.cuda.synchronize()
    nbytes = 2 * (M * K + K * D + D + M * D + 2 * M * D) + 4 * 2 * D
    bms, by = bound(nbytes, 2 * M * K * D + 10 * M * D, BF16_FLOPS)

    ls16, lb16 = ln_s.to(bf), ln_b.to(bf)

    def lib_out(a, w, b, *_):
        return F.layer_norm(torch.addmm(b, a, w), (D,), ls16, lb16, 1e-5)

    row = {"kernel": "fused_out_ln",
           "shape": f"M={M} K={K} N={D} bf16 zero residual (hybrid)",
           "route": route,
           "max_abs_err": max(max_err(z, zr), max_err(h, hr)), "tol": tol,
           **tc_times(torch, timer, (a, w, b, zero, ln_s, ln_b),
                      fused_out_ln, out_ln_reference, lib_out),
           "bound_ms": bms, "bound_by": by}
    report(results, row, within(z, zr, **tol) and within(h, hr, **tol))

    out, route = routed("fused_ffn_ln", lambda: fused_ffn_ln(
        x, w1, b1, w2, b2, zero), "tc")
    ref = ffn_ln_reference(x, w1, b1, w2, b2, zero)
    torch.cuda.synchronize()
    nbytes = 2 * (M * D + D * I + I + I * D + D + M * D + M * D)
    bms, by = bound(nbytes, 4 * M * D * I + 10 * M * I, BF16_FLOPS)

    def lib_ffn(x, w1, b1, w2, b2, _):
        u = F.gelu(torch.addmm(b1, x, w1), approximate="tanh")
        return torch.addmm(b2, u, w2)

    row = {"kernel": "fused_ffn_ln",
           "shape": f"M={M} H={D} I={I} bf16 zero residual (hybrid)",
           "route": route, "max_abs_err": max_err(out, ref), "tol": tol,
           **tc_times(torch, timer, (x, w1, b1, w2, b2, zero), fused_ffn_ln,
                      ffn_ln_reference, lib_ffn),
           "bound_ms": bms, "bound_by": by}
    report(results, row, within(out, ref, **tol))
    del w1, w2, x, out, ref
    torch.cuda.empty_cache()

    B, H, T, Dh = 1, 8, TRAIN_TOKENS, 128
    lib_fwd, lib_bwd = sdpa_yardsticks(torch, B, H, is_causal=True)
    q, k, v, do = (torch.randn(B * H, T, Dh, generator=g, device="cuda")
                   .to(bf) for _ in range(4))
    flash_rows(torch, timer, results, q, k, v, do,
               (Dh ** -0.5, True, None, 0, 0.0),
               f"B={B} H={H} T={T} D={Dh} causal bf16 (hybrid)", BF16_FLOPS,
               B * H * T * (T + 1) // 2, 0, lib_fwd, lib_bwd)

    R = M
    zs = rn(R, D)
    dy = rn(R, D)
    sets = range(16)
    zss, dys = [zs.clone() for _ in sets], [dy.clone() for _ in sets]

    def each(fn):
        return timer.queued([lambda i=i: fn(i) for i in sets])

    (y, mean, rstd), route = routed(
        "layer_norm_fwd", lambda: ln._fwd_kernel(zs, ln_s, ln_b, 1e-5),
        "row")
    y_r, mean_r, rstd_r = ln.layer_norm_reference(zs, ln_s, ln_b, 1e-5)
    torch.cuda.synchronize()
    bms, by = bound(2 * R * D * 2 + 8 * D + 8 * R, 8 * R * D)
    row = {"kernel": "layer_norm_fwd", "shape": f"R={R} C={D} bf16 "
           f"(hybrid)", "route": route, "max_abs_err": max_err(y, y_r),
           "tol": tol,
           "kernel_ms": each(lambda i: ln._fwd_kernel(zss[i], ln_s, ln_b,
                                                      1e-5)),
           "plain_ms": each(lambda i: ln.layer_norm_reference(
               zss[i], ln_s, ln_b, 1e-5)),
           "library_ms": each(lambda i: F.layer_norm(
               zss[i], (D,), ls16, lb16, 1e-5)),
           "bound_ms": bms, "bound_by": by}
    report(results, row, within(y, y_r, **tol)
           and within(mean, mean_r, 1e-4, 1e-4)
           and within(rstd, rstd_r, 1e-4, 1e-4))
    dx, route = routed("layer_norm_bwd_dx", lambda: ln._bwd_dx_kernel(
        zs, ln_s, mean, rstd, dy), "row")
    dx_r = ln.layer_norm_bwd_dx_reference(zs, ln_s, mean, rstd, dy)
    torch.cuda.synchronize()
    bms, by = bound(3 * R * D * 2 + 4 * D + 8 * R, 11 * R * D)
    _, m2, r2 = torch.native_layer_norm(zs, [D], ls16, lb16, 1e-5)
    row = {"kernel": "layer_norm_bwd_dx", "shape": f"R={R} C={D} bf16 "
           f"(hybrid)", "route": route, "max_abs_err": max_err(dx, dx_r),
           "tol": tol,
           "kernel_ms": each(lambda i: ln._bwd_dx_kernel(
               zss[i], ln_s, mean, rstd, dys[i])),
           "plain_ms": each(lambda i: ln.layer_norm_bwd_dx_reference(
               zss[i], ln_s, mean, rstd, dys[i])),
           "library_ms": each(
               lambda i: torch.ops.aten.native_layer_norm_backward(
                   dys[i], zss[i], [D], m2, r2, ls16, lb16,
                   [True, False, False])),
           "bound_ms": bms, "bound_by": by}
    report(results, row, within(dx, dx_r, **tol))


def check_mesh_kernels(torch, timer, results):
    """The kernels at the shapes the sp and MoE paths give a rank: rows
    2-3 on an sp_gpt (a) rank's dense blocks (tp = 1, its half of two
    2048-token sequences: M = 2048, D = 2048, I = 8192, bf16, with the
    residual), shapes ending in "(sp)"; rows 4-5 on a moe_gpt rank's
    heads (dp 2: 4 sequences of 1024; tp 2: 6 of GPT-2 small's 12 heads
    of 64; causal bf16), shapes ending in "(moe)". Tolerances as
    check_blocks_bf16 and flash_rows."""
    check_blocks_bf16(torch, timer, results,
                      M=SP_A_BATCH * SP_A_SEQ // SP_A["sp"], tag=" (sp)")
    B, H, T, Dh = MOE_BATCH // MOE_MESH["dp"], 12 // MOE_MESH["tp"], \
        TRAIN_TOKENS, 64
    g = torch.Generator(device="cuda").manual_seed(7)
    lib_fwd, lib_bwd = sdpa_yardsticks(torch, B, H, is_causal=True)
    q, k, v, do = (torch.randn(B * H, T, Dh, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    flash_rows(torch, timer, results, q, k, v, do,
               (Dh ** -0.5, True, None, 0, 0.0),
               f"B={B} H={H} T={T} D={Dh} causal bf16 (moe)", BF16_FLOPS,
               B * H * T * (T + 1) // 2, 0, lib_fwd, lib_bwd)


def ln_grid_ms(torch, timer, name, args, n_sets=16):
    """Device time a call (Timer.queued, n_sets copies of the tensors) of
    the row kernel `name`'s warp route through its C entry point at
    several grids (rows a block x blocks), beside ops/layer_norm.py
    ln_grid's pick ("rule"): a row a warp at 1, 2, 4 and 8 rows a block,
    and 8 or 4 rows a block on one or two blocks an SM, each warp then
    walking rows. args: (x, scale, bias, eps) for layer_norm_fwd, (x,
    scale, mean, rstd, dy) for layer_norm_bwd_dx, (x, res, scale, bias,
    seed, p, eps) for dropout_add_ln_fwd, (z, scale, mean, rstd, dy,
    seed, p) for dropout_add_ln_bwd (no dx at p = 0, as the wrapper)."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops._launch import _drop_args, _dtype_code, _sms
    from paddle_tpu_torch.ops.layer_norm import ln_grid
    x = args[0]
    R, C = x.shape
    code = _dtype_code(x, name)
    sms = _sms(torch.cuda.current_device())
    rule = ln_grid(R, sms)
    stream = torch.cuda.current_stream().cuda_stream

    def stats():
        mean = torch.empty(R, device="cuda")
        return mean, torch.empty_like(mean)

    if name == "layer_norm_fwd":
        lib, n_ptr, floats = "layer_norm", 6, (ctypes.c_float,)
        sets = [(xi, args[1], args[2], torch.empty_like(xi), *stats())
                for xi in (x.clone() for _ in range(n_sets))]
        tail = [R, C, code, float(args[3])]
    elif name == "layer_norm_bwd_dx":
        lib, n_ptr, floats = "layer_norm", 6, ()
        sets = [(x.clone(), args[1], args[2], args[3], args[4].clone(),
                 torch.empty_like(x)) for _ in range(n_sets)]
        tail = [R, C, code]
    elif name == "dropout_add_ln_fwd":
        lib, n_ptr = "fused_residual", 8
        floats = (ctypes.c_uint, ctypes.c_float, ctypes.c_float)
        sets = [(x.clone(), args[1].clone(), args[2], args[3],
                 torch.empty_like(x), torch.empty_like(x), *stats())
                for _ in range(n_sets)]
        tail = [R, C, code, *_drop_args(args[4], args[5]), float(args[6])]
    else:
        lib, n_ptr = "fused_residual", 7
        floats = (ctypes.c_uint, ctypes.c_float)
        seed, on, thr, keep_div = _drop_args(args[5], args[6])
        sets = [(x.clone(), args[1], args[2], args[3], args[4].clone(),
                 torch.empty_like(x) if on else None, torch.empty_like(x))
                for _ in range(n_sets)]
        tail = [R, C, code, seed, on, thr, keep_div]
    fn = _build.function(lib, f"{name}_warp_launch", n_ptr,
                         len(tail) - len(floats),
                         floats + (ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p))

    def run(st, grid):
        err = fn(*(None if t is None else t.data_ptr() for t in st), *tail,
                 *grid, stream)
        if err:
            fail(f"{name} warp route at grid {grid}: CUDA error {err}")

    cands = sorted({(w, math.ceil(R / w)) for w in (1, 2, 4, 8)}
                   | {(8, sms), (8, 2 * sms), (4, sms), (4, 2 * sms), rule})
    times = {"rule": f"{rule[0]}x{rule[1]}"}
    for grid in cands:
        times[f"{grid[0]}x{grid[1]}"] = timer.queued(
            [lambda st=st, grid=grid: run(st, grid) for st in sets])
    del sets
    return times


def check_rows(torch, timer, results):
    """Layer norm and dropout + residual + layer norm, forward and
    backward, at the BERT-base shapes: R = 2048 tokens and R = 16 * 19 =
    304 masked positions, C = 768, eps 1e-12, f32 (the training path's
    type under AMP O1, where layer_norm is on the black list) and bf16.
    Tolerances: f32 |err| <= 1e-4 + 1e-4 |ref| (row sums in another
    order, rsqrtf against rsqrt); bf16 2e-2 + 2e-2 |ref| (f32 arithmetic
    on the same bf16 numbers, one rounding of each output); statistics
    1e-4. The dropout masks must be bit-equal: dx is zero exactly where
    keep_mask dropped. Times are Timer.queued over 16 sets of buffers:
    these kernels run for microseconds, less than their wrappers' host
    time. Every row (layer norm and dal_rows' rows 6-7, p = 0 and 0.1)
    takes the route ln_route picks (read from the route counters, "warp"
    at these shapes) and carries the row route's time and error beside
    it (row_ms, row_max_abs_err: the first port's block-a-row kernel,
    which ln_route gives misaligned copies of the same inputs), a rerun
    checked bit-equal and the warp route at every grid (grid_ms). Row
    7's library time is the autograd backward of
    F.layer_norm(res + F.dropout(x, p)), its graph kept between calls."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import layer_norm as ln
    C, eps = 768, 1e-12
    # the least a launch costs when queued this way: PyTorch's fill kernel
    # on one element, against which the rows' few microseconds are read
    ones = [torch.empty(1, device="cuda") for _ in range(16)]
    print(json.dumps({"phase": "launch_floor", "what": "Tensor.fill_ of "
                      "one float32 element, Timer.queued over 16 calls",
                      "ms": timer.queued([lambda t=t: t.fill_(1.0)
                                          for t in ones])}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(4)
    s = 1.0 + 0.1 * torch.randn(C, generator=g, device="cuda")
    b = 0.1 * torch.randn(C, generator=g, device="cuda")
    for name, dt, t in (("f32", torch.float32, 1e-4),
                        ("bf16", torch.bfloat16, 2e-2)):
        tol = {"atol": t, "rtol": t}
        item = 2 if dt == torch.bfloat16 else 4
        for R in (2048, 304):
            x, res, dy = (torch.randn(R, C, generator=g, device="cuda")
                          .to(dt) for _ in range(3))
            shape = f"R={R} C={C} {name}"
            sl, bl = s.to(dt), b.to(dt)
            sets = range(16)
            xs, rs, dys = ([t.clone() for _ in sets] for t in (x, res, dy))
            # the row route's inputs: misaligned copies
            xm, dym = misaligned(x), misaligned(dy)
            xms, dyms = ([misaligned(t) for t in ts] for ts in (xs, dys))

            def each(fn):
                return timer.queued([lambda i=i: fn(i) for i in sets])

            (y, mean, rstd), route = routed(
                "layer_norm_fwd", lambda: ln._fwd_kernel(x, s, b, eps),
                "warp")
            (y_w, mean_w, rstd_w), _ = routed(
                "layer_norm_fwd", lambda: ln._fwd_kernel(xm, s, b, eps),
                "row")
            y_r, mean_r, rstd_r = ln.layer_norm_reference(x, s, b, eps)
            again = ln._fwd_kernel(x, s, b, eps)
            torch.cuda.synchronize()
            same = all(torch.equal(a, w) for a, w in zip((y, mean, rstd),
                                                         again))
            bms, by = bound(2 * R * C * item + 8 * C + 8 * R, 8 * R * C)
            row = {"kernel": "layer_norm_fwd", "shape": shape,
                   "route": route, "rerun_bit_equal": same,
                   "max_abs_err": max_err(y, y_r),
                   "row_max_abs_err": max_err(y_w, y_r), "tol": tol,
                   "kernel_ms": each(lambda i: ln._fwd_kernel(xs[i], s, b,
                                                              eps)),
                   "row_ms": each(lambda i: ln._fwd_kernel(
                       xms[i], s, b, eps)),
                   "plain_ms": each(lambda i: ln.layer_norm_reference(
                       xs[i], s, b, eps)),
                   "library_ms": each(lambda i: F.layer_norm(
                       xs[i], (C,), sl, bl, eps)),
                   "grid_ms": ln_grid_ms(torch, timer, "layer_norm_fwd",
                                         (x, s, b, eps)),
                   "bound_ms": bms, "bound_by": by}
            report(results, row, same and all(
                within(a, y_r, **tol) and within(m, mean_r, 1e-4, 1e-4)
                and within(r_, rstd_r, 1e-4, 1e-4)
                for a, m, r_ in ((y, mean, rstd), (y_w, mean_w, rstd_w))))

            dx, route = routed("layer_norm_bwd_dx", lambda: ln._bwd_dx_kernel(
                x, s, mean, rstd, dy), "warp")
            dx_w, _ = routed("layer_norm_bwd_dx", lambda: ln._bwd_dx_kernel(
                xm, s, mean, rstd, dym), "row")
            dx_r = ln.layer_norm_bwd_dx_reference(x, s, mean, rstd, dy)
            same = torch.equal(dx, ln._bwd_dx_kernel(x, s, mean, rstd, dy))
            bms, by = bound(3 * R * C * item + 4 * C + 8 * R, 11 * R * C)
            # the library's backward takes its own forward's statistics
            _, m2, r2 = torch.native_layer_norm(x, [C], sl, bl, eps)
            row = {"kernel": "layer_norm_bwd_dx", "shape": shape,
                   "route": route, "rerun_bit_equal": same,
                   "max_abs_err": max_err(dx, dx_r),
                   "row_max_abs_err": max_err(dx_w, dx_r), "tol": tol,
                   "kernel_ms": each(lambda i: ln._bwd_dx_kernel(
                       xs[i], s, mean, rstd, dys[i])),
                   "row_ms": each(lambda i: ln._bwd_dx_kernel(
                       xms[i], s, mean, rstd, dyms[i])),
                   "plain_ms": each(
                       lambda i: ln.layer_norm_bwd_dx_reference(
                           xs[i], s, mean, rstd, dys[i])),
                   "library_ms": each(
                       lambda i: torch.ops.aten.native_layer_norm_backward(
                           dys[i], xs[i], [C], m2, r2, sl, bl,
                           [True, False, False])),
                   "grid_ms": ln_grid_ms(torch, timer, "layer_norm_bwd_dx",
                                         (x, s, mean, rstd, dy)),
                   "bound_ms": bms, "bound_by": by}
            report(results, row, same and within(dx, dx_r, **tol)
                   and within(dx_w, dx_r, **tol))

            for p in (0.0, 0.1):
                dal_rows(torch, timer, results, each, shape, p,
                         (x, res, dy, s, b, sl, bl, xs, rs, dys), tol)


def dal_rows(torch, timer, results, each, shape, p, data, tol):
    """Rows 6-7 at one shape and p, as check_rows' layer-norm rows: the
    route ln_route picks ("warp" here; read from the counters), the row
    route on misaligned copies (row_ms, row_max_abs_err), a rerun
    bit-equal, every grid of the warp route (grid_ms), the masks of both
    routes bit-equal. Row 7 at p = 0 writes dres alone and returns it as
    dx too (dx_is_dres): its bound counts the three tensors it moves."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import fused_residual as fr
    x, res, dy, s, b, sl, bl, xs, rs, dys = data
    R, C = x.shape
    eps, seed = 1e-12, 20240917
    item = x.element_size()
    sets = range(len(xs))
    pshape = f"{shape} p={p}"
    xm, resm, dym = (misaligned(t) for t in (x, res, dy))
    xms, rms, dyms = ([misaligned(t) for t in ts] for ts in (xs, rs, dys))

    def fwd(a, r_):
        return fr._fwd_kernel(a, r_, s, b, seed, p, eps)

    (y, z, mean, rstd), route = routed("dropout_add_ln_fwd",
                                       lambda: fwd(x, res), "warp")
    (y_w, z_w, mean_w, rstd_w), _ = routed("dropout_add_ln_fwd",
                                           lambda: fwd(xm, resm), "row")
    again = fwd(x, res)
    y_r, z_r, mean_r, rstd_r = fr.dropout_add_ln_reference(
        x, res, s, b, seed, p, eps)
    torch.cuda.synchronize()
    same = all(torch.equal(a, w) for a, w in zip((y, z, mean, rstd), again))
    bms, by = bound(4 * R * C * item + 8 * C + 8 * R, 10 * R * C)
    row = {"kernel": "dropout_add_ln_fwd", "shape": pshape, "route": route,
           "rerun_bit_equal": same,
           "max_abs_err": max(max_err(y, y_r), max_err(z, z_r)),
           "row_max_abs_err": max(max_err(y_w, y_r), max_err(z_w, z_r)),
           "tol": tol,
           "kernel_ms": each(lambda i: fwd(xs[i], rs[i])),
           "row_ms": each(lambda i: fwd(xms[i], rms[i])),
           "plain_ms": each(lambda i: fr.dropout_add_ln_reference(
               xs[i], rs[i], s, b, seed, p, eps)),
           "library_ms": each(lambda i: F.layer_norm(
               rs[i] + F.dropout(xs[i], p), (C,), sl, bl, eps)),
           "grid_ms": ln_grid_ms(torch, timer, "dropout_add_ln_fwd",
                                 (x, res, s, b, seed, p, eps)),
           "bound_ms": bms, "bound_by": by}
    report(results, row, same and all(
        within(a, y_r, **tol) and within(z_, z_r, **tol)
        and within(m, mean_r, 1e-4, 1e-4) and within(r_, rstd_r, 1e-4, 1e-4)
        for a, z_, m, r_ in ((y, z, mean, rstd),
                             (y_w, z_w, mean_w, rstd_w))))

    zs = [z.clone() for _ in sets]
    zm, zms = misaligned(z), [misaligned(t) for t in zs]
    # the library's backward: autograd through its own forward on each
    # set, the graph kept for every timed call
    xg = [t.clone().requires_grad_() for t in xs]
    rg = [t.clone().requires_grad_() for t in rs]
    outs = [F.layer_norm(rg[i] + F.dropout(xg[i], p), (C,), sl, bl, eps)
            for i in sets]

    def bwd(z_, dy_):
        return fr._bwd_kernel(z_, s, mean, rstd, dy_, seed, p)

    (dx, dres), route = routed("dropout_add_ln_bwd", lambda: bwd(z, dy),
                               "warp")
    (dx_w, dres_w), _ = routed("dropout_add_ln_bwd", lambda: bwd(zm, dym),
                               "row")
    again = bwd(z, dy)
    dx_r, dres_r = fr.dropout_add_ln_bwd_reference(z, s, mean, rstd, dy,
                                                   seed, p)
    torch.cuda.synchronize()
    same = torch.equal(dx, again[0]) and torch.equal(dres, again[1])
    one = dx is dres and dx_w is dres_w
    masks_equal = True
    if p > 0:
        keep = fr.keep_mask(seed, R, C, p, "cuda")
        masks_equal = all(bool(torch.equal(a != 0, keep & (w != 0)))
                          for a, w in ((dx, dres), (dx_w, dres_w)))
    # p = 0: z, dy and dres; p > 0: dx too
    bms, by = bound((3 if p == 0 else 4) * R * C * item + 4 * C + 8 * R,
                    13 * R * C)
    row = {"kernel": "dropout_add_ln_bwd", "shape": pshape, "route": route,
           "rerun_bit_equal": same, "dx_is_dres": one,
           "max_abs_err": max(max_err(dx, dx_r), max_err(dres, dres_r)),
           "row_max_abs_err": max(max_err(dx_w, dx_r),
                                  max_err(dres_w, dres_r)),
           "tol": tol, "masks_bit_equal": masks_equal,
           "kernel_ms": each(lambda i: bwd(zs[i], dys[i])),
           "row_ms": each(lambda i: bwd(zms[i], dyms[i])),
           "plain_ms": each(lambda i: fr.dropout_add_ln_bwd_reference(
               zs[i], s, mean, rstd, dys[i], seed, p)),
           "library_ms": each(lambda i: torch.autograd.grad(
               outs[i], (xg[i], rg[i]), dys[i], retain_graph=True)),
           "grid_ms": ln_grid_ms(torch, timer, "dropout_add_ln_bwd",
                                 (z, s, mean, rstd, dy, seed, p)),
           "bound_ms": bms, "bound_by": by}
    report(results, row, same and masks_equal and one == (p == 0) and all(
        within(a, dx_r, **tol) and within(w, dres_r, **tol)
        for a, w in ((dx, dres), (dx_w, dres_w))))


def check_blocks_bert(torch, timer, results):
    """The sub-blocks as the BERT-base step launches them: M = 2048
    tokens, D = H = 768, I = 3072, dropout 0.1, eps 1e-12; fused_ffn_ln
    with the erf-polynomial gelu and post-norm. f32 is the path's type
    (AMP O1 leaves both block ops off its lists, so they see f32 weights
    and residuals); bf16 beside it. Tolerances as in check_blocks /
    check_blocks_bf16, the f32 one widened to 2e-4 for the division by
    1 - p and the I = 3072 sums. A zero residual exposes the mask: z is
    zero exactly where keep_mask dropped. The f32 rows must take the
    FFMA route, the bf16 rows the tensor cores."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.fused_block import (
        ffn_ln_reference, fused_ffn_ln, fused_out_ln, out_ln_reference)
    from paddle_tpu_torch.ops.fused_residual import keep_mask
    M, D, I, p, eps, seed = BERT_BATCH * BERT_SEQ, 768, 3072, 0.1, 1e-12, 77
    g = torch.Generator(device="cuda").manual_seed(5)
    for name, dt, peak, tol in (
            ("f32", torch.float32, F32_FLOPS, {"atol": 2e-4, "rtol": 2e-4}),
            ("bf16", torch.bfloat16, BF16_FLOPS,
             {"atol": 2e-2, "rtol": 2e-2})):
        item = 2 if dt == torch.bfloat16 else 4

        def rn(*shape, s=1.0, dt=dt):
            return (torch.randn(*shape, generator=g, device="cuda")
                    * s).to(dt)

        w, b = rn(D, D, s=0.02), rn(D, s=0.02)
        ln_s = rn(D, s=0.1, dt=torch.float32) + 1.0
        ln_b = rn(D, s=0.1, dt=torch.float32)
        w1, b1 = rn(D, I, s=0.02), rn(I, s=0.02)
        w2, b2 = rn(I, D, s=0.02), rn(D, s=0.02)
        a, res, x = rn(M, D), rn(M, D), rn(M, D)
        ls, lb = ln_s.to(dt), ln_b.to(dt)

        want = "ffma" if dt == torch.float32 else "tc"
        args = (a, w, b, res, ln_s, ln_b, p, eps, seed)
        (z, h), route = routed("fused_out_ln", lambda: fused_out_ln(*args),
                               want)
        zr, hr = out_ln_reference(*args)
        z0, _ = fused_out_ln(a, w, b, torch.zeros_like(res), ln_s, ln_b, p,
                             eps, seed)
        torch.cuda.synchronize()
        masks_equal = bool(torch.equal(z0 != 0,
                                       keep_mask(seed, M, D, p, "cuda")))
        bms, by = bound(item * (M * D + D * D + D + M * D + 2 * M * D)
                        + 8 * D, 2 * M * D * D + 12 * M * D, peak)

        def lib_out(a, w, b, res, *_):
            zz = F.dropout(torch.addmm(b, a, w), p).add_(res)
            return F.layer_norm(zz, (D,), ls, lb, eps)

        times = tc_times(torch, timer, args, fused_out_ln, out_ln_reference,
                         lib_out) if dt == torch.bfloat16 else {
            "kernel_ms": timer(lambda: fused_out_ln(*args)),
            "plain_ms": timer(lambda: out_ln_reference(*args)),
            "library_ms": timer(lambda: lib_out(*args)),
            "device_ms": device_ms(torch, timer, fused_out_ln, args),
            "tile_ms": ffma_tile_ms(torch, timer, "fused_out_ln", args)}
        row = {"kernel": "fused_out_ln",
               "shape": f"M={M} D={D} {name} p={p} (BERT)", "route": route,
               "max_abs_err": max(max_err(z, zr), max_err(h, hr)),
               "tol": tol, "masks_bit_equal": masks_equal, **times,
               "bound_ms": bms, "bound_by": by}
        report(results, row, masks_equal and within(z, zr, **tol)
               and within(h, hr, **tol))

        fargs = (x, w1, b1, w2, b2, res, ln_s, ln_b, "gelu", "post", p, eps,
                 seed)
        out, route = routed("fused_ffn_ln", lambda: fused_ffn_ln(*fargs),
                            want)
        ref = ffn_ln_reference(*fargs)
        torch.cuda.synchronize()
        bms, by = bound(item * (M * D + D * I + I + I * D + D + 2 * M * D)
                        + 8 * D, 4 * M * D * I + 25 * M * I + 12 * M * D,
                        peak)

        def lib_ffn(x, w1, b1, w2, b2, res, *_):
            u = F.gelu(torch.addmm(b1, x, w1))
            zz = F.dropout(torch.addmm(b2, u, w2), p).add_(res)
            return F.layer_norm(zz, (D,), ls, lb, eps)

        times = tc_times(torch, timer, fargs, fused_ffn_ln, ffn_ln_reference,
                         lib_ffn) if dt == torch.bfloat16 else {
            "kernel_ms": timer(lambda: fused_ffn_ln(*fargs)),
            "plain_ms": timer(lambda: ffn_ln_reference(*fargs)),
            "library_ms": timer(lambda: lib_ffn(*fargs)),
            "device_ms": device_ms(torch, timer, fused_ffn_ln, fargs),
            "tile_ms": ffma_tile_ms(torch, timer, "fused_ffn_ln", fargs)}
        row = {"kernel": "fused_ffn_ln",
               "shape": f"M={M} H={D} I={I} {name} gelu post p={p} (BERT)",
               "route": route, "max_abs_err": max_err(out, ref), "tol": tol,
               **times, "bound_ms": bms, "bound_by": by}
        report(results, row, within(out, ref, **tol))


def check_flash_block_override(torch):
    """Fault C3: with the reference's PADDLE_TPU_FLASH_BLOCK_K (and _Q)
    at 64, the reference rounds P at 64-key blocks; the port's plain
    versions follow (ref_block), and so must both kernel routes. At
    B=1 H=2 T=1024 D=64 bf16, causal and not, on the tensor-core route
    and on the SIMT route (misaligned copies), each kernel against its
    plain version, under the knob and without it (the reference's
    default, 512-key blocks). The block moves only the forward's
    rounding of P: o must have at most 1% of its elements another bf16
    number under the knob (the plain versions at the two blocks differ
    in ~30%); dq, dk and dv round dS elementwise whatever the block, so
    under the knob they must be within 2e-2 + 2e-2 |ref| and differ in
    no larger a share than without it (+ 0.5%: their long f32 sums in
    another order)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    BH, T, D = 2, 1024, 64
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = (torch.randn(BH, T, D, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    knobs = ("PADDLE_TPU_FLASH_BLOCK_Q", "PADDLE_TPU_FLASH_BLOCK_K")
    saved = {n: os.environ.get(n) for n in knobs}

    def shares(route, args, tail):
        """Each output's share of elements off the plain version, and
        whether all are within the bf16 tolerance."""
        o_r, lse_r = fa.flash_fwd_reference(q, k, v, *tail)
        ref = (o_r, *fa.flash_bwd_reference(q, k, v, o_r, lse_r, do,
                                             *tail))
        (o, lse), _ = routed("flash_fwd",
                             lambda: fa._fwd_kernel(*args[:3], *tail), route)
        bargs = (*args, lse, fa.bwd_delta(o, args[3]))
        dq, _ = routed("flash_bwd_dq", lambda: fa._dq_kernel(*bargs, *tail),
                       route)
        (dk, dv), _ = routed("flash_bwd_dkv",
                             lambda: fa._dkv_kernel(*bargs, *tail), route)
        torch.cuda.synchronize()
        got = (o, dq, dk, dv)
        return ({n: differ(a, b) for n, a, b in zip(("o", "dq", "dk", "dv"),
                                                    got, ref)},
                all(within(a, b, 2e-2, 2e-2) for a, b in zip(got, ref)),
                o_r)

    rows, ok = [], True
    try:
        for causal in (True, False):
            tail = (D ** -0.5, causal, None, 0, 0.0)
            for route, args in (("tc", (q, k, v, do)),
                                ("simt", tuple(misaligned(x) for x in
                                               (q, k, v, do)))):
                for n in knobs:
                    os.environ.pop(n, None)
                base, base_ok, o512 = shares(route, args, tail)
                os.environ.update({n: "64" for n in knobs})
                if fa.ref_block(T) != 64:
                    fail(f"C3: ref_block({T}) = {fa.ref_block(T)} under "
                         f"the knob at 64")
                knob, knob_ok, o64 = shares(route, args, tail)
                row_ok = knob_ok and base_ok and knob["o"] <= 0.01 and all(
                    knob[n] <= max(0.01, base[n] + 0.005)
                    for n in ("dq", "dk", "dv"))
                ok = ok and row_ok
                rows.append({"causal": causal, "route": route,
                             "differ_block64": knob,
                             "differ_block512": base, "ok": row_ok,
                             "plain_o_block64_vs_512": differ(o64, o512)})
    finally:
        for n, val in saved.items():
            if val is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = val
    print(json.dumps({"check": "flash_block_override", "fault": "C3",
                      "shape": f"BH={BH} T={T} D={D} bf16",
                      "knob": "PADDLE_TPU_FLASH_BLOCK_Q/_K=64", "rows": rows,
                      "tol": "o <= 1% differ; dq, dk, dv within 2e-2 + "
                             "2e-2 |ref| and <= max(1%, block-512 share "
                             "+ 0.5%)"}), flush=True)
    if not ok:
        fail(f"C3: a flash route does not round at 64-key blocks: {rows}")


def check_flash_bert(torch, timer, results):
    """The three flash kernels as the BERT-base step launches them:
    B=16, H=12, S=T=128, D=64, non-causal, dropout 0.1, in bf16 (the
    path's type: fused_attention is on the O1 white list; the
    tensor-core route) and f32 (SIMT), with and without a padding mask
    (B, 1, 1, T) whose rows pad 0..45 trailing keys; flash_rows has the
    tolerances. Two identity-block V's expose the dropout mask bit for
    bit (masks_bit_equal)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    B, H, T, D, p, seed = BERT_BATCH, 12, BERT_SEQ, 64, 0.1, 4242
    BH = B * H
    scale = D ** -0.5
    g = torch.Generator(device="cuda").manual_seed(6)
    pad = torch.zeros(B, T, device="cuda")
    for i in range(B):
        pad[i, T - 3 * i:] = -1e9 if i else 0.0
    n_el = BH * T * T
    for name, dt, peak in (("bf16", torch.bfloat16, BF16_FLOPS),
                           ("f32", torch.float32, F32_FLOPS)):
        q, k, v, do = (torch.randn(BH, T, D, generator=g, device="cuda")
                       .to(dt) for _ in range(4))

        # the mask bit for bit: o = dropped P when V is an identity block
        keep = fa.keep_mask_salted(seed, BH, T, T, p, "cuda")
        masks_equal = True
        for half in (0, 1):
            vi = torch.zeros(BH, T, D, device="cuda", dtype=dt)
            vi[:, half * D:(half + 1) * D] = torch.eye(D, device="cuda")
            oi, _ = fa._fwd_kernel(q * 0.2, k * 0.2, vi, scale, False, None,
                                   seed, p)
            masks_equal &= bool(torch.equal(
                oi != 0, keep[:, :, half * D:(half + 1) * D]))
        del keep

        for mask2, mname in ((None, "no mask"), (pad, "padding mask")):
            mask4 = None if mask2 is None else mask2[:, None, None, :].to(dt)
            lib_fwd, lib_bwd = sdpa_yardsticks(torch, B, H, attn_mask=mask4,
                                               dropout_p=p)
            flash_rows(
                torch, timer, results, q, k, v, do,
                (scale, False, mask2, seed, p),
                f"B={B} H={H} S=T={T} D={D} {name} p={p} {mname} (BERT)",
                peak, n_el, 0 if mask2 is None else 4 * B * T, lib_fwd,
                lib_bwd, {"masks_bit_equal": masks_equal})
        if not masks_equal:
            fail(f"flash dropout masks differ from keep_mask_salted ({name})")


def request_mix(vocab: int):
    """8 requests, prompt lengths from the serving benchmark's mix
    {16, 31, 64, 100, 128, 192}, 16-32 new tokens; request 0 and
    request 7 share a 64-token (4-page) prefix; request 5 samples."""
    import numpy as np
    rng = np.random.RandomState(0)
    plens = [128, 16, 31, 64, 100, 192, 31, 100]
    news = [24, 16, 32, 20, 28, 32, 16, 24]
    mix = []
    for i, (pl, mn) in enumerate(zip(plens, news)):
        prompt = rng.randint(0, vocab, (pl,))
        kw = dict(temperature=0.8, top_k=40, top_p=0.95, seed=1234) \
            if i == 5 else {}
        mix.append([prompt, mn, kw])
    mix[7][0][:64] = mix[0][0][:64]
    return mix


def serve_mix(eng, mix):
    """Phase 3's order: request 0, one step (its prefill, so its pages
    are cached for request 7), then the other seven; run to idle on the
    calling thread. Returns the requests."""
    first = eng.submit(mix[0][0], mix[0][1], **mix[0][2])
    eng.step()
    reqs = [first] + [eng.submit(p, n, **kw) for p, n, kw in mix[1:]]
    eng.run_until_idle()
    return reqs


def serving_path(torch, tree):
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.serving import Engine, GPTDecodeModel
    cfg = GPTConfig.gpt3_1p3b()
    t0 = time.perf_counter()
    model = GPTDecodeModel(cfg, params=tree)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "model", "config": "gpt3_1p3b",
                      "upload_s": round(time.perf_counter() - t0, 2)}),
          flush=True)
    eng = serving_engine(model, prefix_cache_pages=64)
    mix = request_mix(cfg.vocab_size)
    by_call = tap_sub_block_routes(model)

    reset_launch_counts()
    t0 = time.perf_counter()
    reqs = serve_mix(eng, mix)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()

    bad = [(r.id, r.status, r.error) for r in reqs if r.status != "done"]
    if bad:
        fail(f"requests not done: {bad}")
    for r, (_p, n, _kw) in zip(reqs, mix):
        toks = r.result()
        if len(toks) != n or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            fail(f"request {r.id}: {len(toks)} tokens, range "
                 f"[{toks.min()}, {toks.max()}]")
    missing = [k for k in SERVING_KERNELS if counts.get(k, 0) <= 0]
    if missing:
        fail(f"kernels never launched on the serving path: {missing} "
             f"(counts {counts})")
    # GPT-3 XL's heads (d = 128, pages of 16, f32 pools): every paged
    # attention call on the vector kernel
    if counts.get("paged_attention.scalar", 0) \
            or counts.get("paged_attention.vector", 0) \
            != counts["paged_attention"]:
        fail(f"serving path: paged attention off the vector kernel: "
             f"{counts}")
    for name in ("prefill", "prefill_tail", "decode"):   # the class's again
        delattr(model, name)
    check_serving_routes(by_call)
    st = eng.stats()
    if st["prefix_cache"]["hits"] < 1 \
            or not any(k.startswith("prefill_tail") for k in st["compiles"]):
        fail(f"shared-prefix request did not take prefill_tail: "
             f"{st['prefix_cache']} {st['compiles']}")
    ntok = sum(len(r.generated) for r in reqs)
    h = eng._m_decode_h
    main = {"phase": "serving_path", "requests": len(reqs), "tokens": ntok,
            "wall_s": round(wall, 3), "tokens_per_s": round(ntok / wall, 2),
            "latency_ms_p50": st["latency_ms_p50"],
            "latency_ms_p99": st["latency_ms_p99"],
            "decode_steps": st["steps"],
            "decode_step_ms_mean": round(h.sum / h.count * 1e3, 3),
            "compiles": st["compiles"], "launches": counts,
            "sub_block_routes": by_call}
    print(json.dumps(main), flush=True)

    # one greedy request again, served by the plain versions on the card
    plain_model = GPTDecodeModel(dataclasses.replace(cfg,
                                                     fused_blocks=False),
                                 params=model.params, attn_impl="plain")
    plain = Engine(plain_model, num_slots=8, num_pages=64, page_size=16)
    p, n, _ = mix[3]
    pr = plain.submit(p, n)
    plain.run_until_idle()
    got, want = reqs[3].result().tolist(), pr.result().tolist()
    print(json.dumps({"phase": "plain_parity", "request": 3,
                      "kernel_tokens": got, "plain_tokens": want}),
          flush=True)
    if got != want:
        fail("greedy tokens differ between the kernels and the plain "
             "versions")
    return counts, eng, [r.result().tolist() for r in reqs], main


def checkpoint_phase(torch, eng, want, keep=False):
    """Item 2 on phase 3's GPT-3 XL engine: save eng.model under a fresh
    temporary root, save it again unchanged (every chunk of the second
    save a dedup hit: nothing written), build
    Engine.from_checkpoint with phase 3's engine arguments and replay
    request_mix in phase 3's order (all 8 requests, the seeded sampled
    request 5 included, must give phase 3's tokens `want`); then a third
    engine on zero weights of the same shapes, made on the card, its
    scheduler thread running, warm-started with version 7 while a
    request is in flight, replays the mix to the same tokens and
    reports model_version 7. The root is removed at the end, success or
    failure, unless `keep`: then a run that succeeds returns it (the
    online phase publishes into this store); a disk too small for one
    copy of the weights fails."""
    import shutil
    import tempfile
    import numpy as np
    from paddle_tpu_torch.checkpoint import CheckpointStore
    from paddle_tpu_torch.observability import REGISTRY
    from paddle_tpu_torch.serving import Engine, GPTDecodeModel
    kw = dict(num_slots=8, num_pages=SERVE_PAGES, page_size=SERVE_PAGE,
              prefix_cache_pages=64)
    cfg = eng.model.cfg
    mix = request_mix(cfg.vocab_size)
    params = eng.model.params
    leaves = [params[k] for k in params if k != "blocks"] \
        + [t for blk in params["blocks"] for t in blk.values()]
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    written = REGISTRY.get("paddle_tpu_ckpt_chunks_written_total")
    dedup = REGISTRY.get("paddle_tpu_ckpt_chunks_dedup_hits_total")
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ok = False
    try:
        free = shutil.disk_usage(root).free
        print(json.dumps({"phase": "checkpoint_disk", "root": root,
                          "free_bytes": free, "weights_bytes": nbytes}),
              flush=True)
        if free < 1.05 * nbytes:
            fail(f"checkpoint: {free} bytes free under {root}, the "
                 f"weights need {nbytes}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng.model.save_checkpoint(root)
        save_s = time.perf_counter() - t0
        st = CheckpointStore(root)
        ents = st.latest_manifest()["arrays"]
        chunks = sum(len(e["chunks"]) for e in ents.values())
        on_disk = st.chunks.all_digests()
        w0, d0 = written.value, dedup.value
        t0 = time.perf_counter()
        eng.model.save_checkpoint(root)
        resave_s = time.perf_counter() - t0
        new_chunks = int(written.value - w0)
        hits = int(dedup.value - d0)
        if new_chunks or hits != chunks or st.steps() != [1, 2] \
                or st.chunks.all_digests() != on_disk:
            fail(f"checkpoint: the unchanged second save wrote "
                 f"{new_chunks} chunks and hit {hits} of {chunks}")
        t0 = time.perf_counter()
        eng2 = Engine.from_checkpoint(root, **kw)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = [r.result().tolist() for r in serve_mix(eng2, mix)]
        if got != want:
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            fail(f"checkpoint: the engine built from the checkpoint "
                 f"differs from phase 3 on requests {bad}")
        del eng2
        gc.collect()
        torch.cuda.empty_cache()
        zeros = {k: torch.zeros_like(v) for k, v in params.items()
                 if k != "blocks"}
        zeros["blocks"] = [{k: torch.zeros_like(v) for k, v in b.items()}
                           for b in params["blocks"]]
        eng3 = Engine(GPTDecodeModel(cfg, params=zeros), **kw)
        probe = np.random.RandomState(99).randint(0, cfg.vocab_size, (20,))
        with eng3:                      # the scheduler thread serves
            busy = eng3.submit(probe, 64)
            t0 = time.perf_counter()
            eng3.warm_start(root, version=7)
            warm_s = time.perf_counter() - t0
            busy.result(300)
        version = eng3.stats()["model_version"]
        got3 = [r.result().tolist() for r in serve_mix(eng3, mix)]
        peak = torch.cuda.max_memory_allocated()
        del eng3, zeros
        gc.collect()
        torch.cuda.empty_cache()
        row = {"phase": "checkpoint", "config": "gpt3_1p3b f32, 1 MiB "
               "chunks, engine of phase 3", "bytes": nbytes,
               "arrays": len(ents), "chunks": chunks,
               "save_s": round(save_s, 3),
               "save_gb_per_s": round(nbytes / save_s / 1e9, 3),
               "resave_s": round(resave_s, 3),
               "resave_gb_per_s": round(nbytes / resave_s / 1e9, 3),
               "resave_chunks_written": new_chunks,
               "resave_dedup_hits": hits,
               "from_checkpoint_s": round(restore_s, 3),
               "from_checkpoint_gb_per_s": round(nbytes / restore_s / 1e9,
                                                 3),
               "warm_start_s": round(warm_s, 3),
               "warm_start_gb_per_s": round(nbytes / warm_s / 1e9, 3),
               "warm_start_during_request": busy.status,
               "model_version": version,
               "tokens_equal_phase3": got == want,
               "warm_tokens_equal_phase3": got3 == want,
               "max_memory_allocated_gb": round(peak / 1e9, 3)}
        print(json.dumps(row), flush=True)
        if got3 != want:
            bad = [i for i, (g, w) in enumerate(zip(got3, want)) if g != w]
            fail(f"checkpoint: the warm-started engine differs from "
                 f"phase 3 on requests {bad}")
        if version != 7 or busy.status != "done":
            fail(f"checkpoint: warm start left model_version {version}, "
                 f"the in-flight request {busy.status}")
        ok = True
    finally:
        if not (keep and ok):
            shutil.rmtree(root, ignore_errors=True)
    return root if keep else None


def serving_engine(model, prefix_cache_pages=0):
    """An engine with phase 3's slots and pool over `model`'s weights
    (shared, not uploaded again)."""
    from paddle_tpu_torch.serving import Engine
    return Engine(model, num_slots=8, num_pages=SERVE_PAGES,
                  page_size=SERVE_PAGE,
                  prefix_cache_pages=prefix_cache_pages)


def wire_serving_phase(torch, eng, want, inproc):
    """Item 15 on phase 3's GPT-3 XL weights: a ServingServer on
    127.0.0.1:0 in front of a fresh engine with phase 3's arguments
    (weights shared: no second upload); one ServingClient replays
    request_mix over the mux wire in phase 3's order — request 0 first,
    streamed, the other seven from their own threads once its first
    token arrived (its prompt is then in the prefix cache, so request 7
    takes prefill_tail as in phase 3), request 5 seeded and sampled,
    requests 2 and 6 streamed too. Every reply must be "done" with phase
    3's tokens `want` (the streamed frames reassemble them); ping_info,
    stats, metrics and debug_dump(write=False) must answer; rows 1-3
    must launch during the phase (counts set to 0 just before, read just
    after), paged attention on the vector kernel only. Prints the wire
    requests, tokens, wall and tokens/s beside phase 3's `inproc`."""
    import threading
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.serving import ServingClient, ServingServer
    mix = request_mix(eng.model.cfg.vocab_size)
    weng = serving_engine(eng.model, prefix_cache_pages=64)
    streamed = (0, 2, 6)
    reps = [None] * len(mix)
    frames = {i: [] for i in streamed}
    errors = []
    first = threading.Event()
    with ServingServer(weng, "127.0.0.1:0") as srv:
        cli = ServingClient(srv.endpoint)
        try:
            def call(i):
                p, n, kw = mix[i]

                def on_token(toks, idx):
                    frames[i].extend(int(t) for t in toks)
                    first.set()
                try:
                    reps[i] = cli.generate(
                        p, n, timeout=300, stream=i in streamed,
                        on_token=on_token if i in streamed else None,
                        **kw)
                except Exception as e:
                    errors.append(f"request {i}: {type(e).__name__}: {e}")
                finally:
                    first.set()

            reset_launch_counts()
            t0 = time.perf_counter()
            th0 = threading.Thread(target=call, args=(0,))
            th0.start()
            first.wait(300)
            rest = [threading.Thread(target=call, args=(i,))
                    for i in range(1, len(mix))]
            for th in rest:
                th.start()
            for th in [th0] + rest:
                th.join(600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            ping = cli.ping_info()
            st = cli.stats()
            text = cli.metrics()
            dump = cli.debug_dump(write=False)
        finally:
            cli.close()
    if errors:
        fail(f"wire_serving: {errors}")
    bad = [(i, r and r.get("status"), r and r.get("error"))
           for i, r in enumerate(reps)
           if r is None or r.get("status") != "done"]
    if bad:
        fail(f"wire_serving: requests not done: {bad}")
    got = [r["tokens"].tolist() for r in reps]
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            fail(f"wire_serving: request {i} tokens over the wire {g} != "
                 f"in-process {w}")
    for i in streamed:
        if frames[i] != got[i]:
            fail(f"wire_serving: request {i} streamed {frames[i]} != "
                 f"final {got[i]}")
    key = f"serving.engine.{weng.engine_id}"
    if not (ping.get("ok") is True and ping.get("draining") is False
            and isinstance(ping.get("tokens_per_s_per_chip"), float)):
        fail(f"wire_serving: ping_info {ping}")
    if st.get("completed", 0) < len(mix) or "compiles" not in st:
        fail(f"wire_serving: stats {st}")
    if "paddle_tpu_serving_tokens_total" not in text \
            or "paddle_tpu_rpc_server_requests_total" not in text:
        fail("wire_serving: metrics lack the serving / rpc series")
    if dump.get("reason") != "debug_dump" or dump.get("path") is not None \
            or key not in dump.get("requests", {}):
        fail(f"wire_serving: debug_dump {sorted(dump)} "
             f"{sorted(dump.get('requests', {}))}")
    missing = [k for k in ("paged_attention.vector", "fused_out_ln",
                           "fused_ffn_ln") if counts.get(k, 0) <= 0]
    if missing or counts.get("paged_attention.scalar", 0):
        fail(f"wire_serving: rows 1-3 did not launch as expected: "
             f"{missing} (counts {counts})")
    ntok = sum(len(g) for g in got)
    print(json.dumps({
        "phase": "wire_serving", "requests": len(mix), "tokens": ntok,
        "wall_s": round(wall, 3), "tokens_per_s": round(ntok / wall, 2),
        "in_process": {k: inproc[k] for k in ("requests", "tokens",
                                              "wall_s", "tokens_per_s")},
        "streamed": list(streamed), "tokens_equal": True,
        "ping_info": ping, "latency_ms_p50": st["latency_ms_p50"],
        "latency_ms_p99": st["latency_ms_p99"],
        "debug_dump_sections": sorted(dump), "launches": counts}),
        flush=True)
    return counts


def slo_traffic(rate, duration=SLO_DURATION):
    """bench.py's _slo_traffic at `rate` for `duration` seconds: prompt
    lengths 4/8/16/32 (weights 3/3/2/1), outputs 4/8/16 (3/2/1), diurnal
    over the run, tenants web:batch 3:1, tiers 0/1/2 with deadlines
    10 s / 20 s / none, token ids under 512."""
    from paddle_tpu_torch.serving import TrafficConfig
    return TrafficConfig(
        rate=rate, duration=duration, arrival="diurnal",
        diurnal_period=duration, seed=SLO_SEED,
        prompt_lens={4: 3, 8: 3, 16: 2, 32: 1},
        output_lens={4: 3, 8: 2, 16: 1},
        tenants={"web": 3, "batch": 1}, tiers={0: 1, 1: 2, 2: 1},
        deadlines={0: 10.0, 1: 20.0, 2: None}, vocab_size=512)


def slo_engine(model):
    """serving_engine over `model` with every prefill bucket of the SLO
    mix (16 and 32 rows) and the decode bucket called once, so no first
    call lands in a measured window (bench.py's _slo_engine)."""
    import numpy as np
    e = serving_engine(model)
    for plen in (4, 8, 16, 32):
        e.submit(np.full((plen,), 1, np.int32), 2)
    e.run_until_idle()
    return e


def load_problems(res, vocab, what):
    """A replay's request errors and out-of-range tokens (attainment is a
    measurement, never a failure)."""
    errs = [(a.index, getattr(h, "error", None)) for a, h in res.handles
            if h.status == "error"]
    out = [f"{what}: requests failed: {errs[:8]}"] if errs else []
    for a, h in res.handles:
        toks = [int(t) for t in h.generated]
        if any(t < 0 or t >= vocab for t in toks):
            out.append(f"{what}: arrival {a.index} token out of range: "
                       f"{toks}")
    return out


def check_load(res, vocab, what):
    """Fails on load_problems."""
    problems = load_problems(res, vocab, what)
    if problems:
        fail("; ".join(problems))


def decode_mark(e):
    """(sum, count) of the engine's decode-step histogram now."""
    h = e._m_decode_h
    return h.sum, h.count


def decode_ms_since(e, mark):
    """Mean decode-step wall ms since `mark`, and the steps counted."""
    s, n = decode_mark(e)
    steps = n - mark[1]
    return (round((s - mark[0]) / steps * 1e3, 3) if steps else None,
            steps)


def slo_row(what, rate, rep, e, mark):
    step_ms, steps = decode_ms_since(e, mark)
    return {"phase": what, "rate_rps": rate, "duration_s": SLO_DURATION,
            "decode_steps": steps, "decode_step_ms_mean": step_ms,
            "offered": rep["offered"], "met": rep["met"],
            "attainment": rep["attainment"],
            "goodput_tokens_per_sec": rep["goodput_tokens_per_sec"],
            "ttft_ms_p50": rep["ttft_ms_p50"],
            "ttft_ms_p99": rep["ttft_ms_p99"],
            "itl_ms_p50": rep["itl_ms_p50"],
            "itl_ms_p99": rep["itl_ms_p99"], "by_status": rep["by_status"],
            "elapsed_s": rep["elapsed_s"]}


def slo_phase(torch, eng):
    """bench_slo's replay on phase 3's GPT-3 XL weights: LoadGenerator on
    slo_traffic, once with run_engine on a fresh slo_engine and once
    with run_client through a ServingServer in front of another. The
    rate starts at SLO_RATE and halves while run_engine misses any
    request's SLO (attainment below 1), down to SLO_MIN_RATE. Prints
    both slo_reports (attainment, goodput, TTFT and inter-token
    percentiles) and the rate used; returns (rate, the run_engine
    result: the chaos drill's baseline, the run_client row: the router
    phase's yardstick)."""
    from paddle_tpu_torch.serving import (LoadGenerator, ServingClient,
                                          ServingServer, slo_report)
    vocab = eng.model.cfg.vocab_size
    rate = SLO_RATE
    while True:
        e = slo_engine(eng.model)
        mark = decode_mark(e)
        with e:
            res = LoadGenerator(slo_traffic(rate),
                                name=f"slo_engine_{rate:g}").run_engine(e)
            if not res.wait(300):
                fail(f"slo: run_engine at {rate} rps not finished in 300 s")
        check_load(res, vocab, "slo run_engine")
        rep = slo_report(res)
        print(json.dumps({**slo_row("slo_engine", rate, rep, e, mark),
                          "preemptions": e.stats()["preemptions"]}),
              flush=True)
        del e
        if rep["attainment"] == 1.0 or rate / 2 < SLO_MIN_RATE:
            break
        rate /= 2
    e = slo_engine(eng.model)
    mark = decode_mark(e)
    with ServingServer(e, "127.0.0.1:0") as srv:
        cli = ServingClient(srv.endpoint)
        try:
            wres = LoadGenerator(slo_traffic(rate),
                                 name=f"slo_wire_{rate:g}").run_client(
                cli, timeout=300)
        finally:
            cli.close()
    check_load(wres, vocab, "slo run_client")
    wire = slo_row("slo_wire", rate, slo_report(wres), e, mark)
    print(json.dumps(wire), flush=True)
    return rate, res, wire


def chaos_phase(torch, eng, rate, base):
    """bench_chaos's drill on phase 3's GPT-3 XL weights: with
    PADDLE_TPU_WATCHDOG_DEADLINE = 0.5 set before a fresh slo_engine is
    built (its watchdog token reads the deadline when registered) and
    PADDLE_TPU_DEBUG_DIR a temporary directory, slo_traffic at `rate`
    runs while a 0.8 s stall is armed at serving_decode (a host sleep in
    the step, under the step lock; the stream is not synchronised).
    WATCHDOG.stalled() must name the engine's token within 30 s and drop
    it within 30 s after the stall clears; the watchdog's bundle must
    load with load_bundle(verify=True) and hold the engine's requests
    snapshot. Prints detection and recovery seconds and the
    post-recovery attainment against `base`, run_engine's result of the
    same traffic."""
    import shutil
    import tempfile
    import threading
    from paddle_tpu_torch.distributed.fleet.runtime import (
        fault_injection as fi)
    from paddle_tpu_torch.observability.debug import (list_bundles,
                                                      load_bundle)
    from paddle_tpu_torch.observability.watchdog import WATCHDOG
    from paddle_tpu_torch.serving import LoadGenerator, slo_report
    saved = {k: os.environ.get(k) for k in (
        "PADDLE_TPU_WATCHDOG_DEADLINE", "PADDLE_TPU_DEBUG_DIR")}
    dbg = tempfile.mkdtemp(prefix="chip_smoke_bundles_")
    try:
        os.environ["PADDLE_TPU_WATCHDOG_DEADLINE"] = str(CHAOS_DEADLINE_S)
        os.environ["PADDLE_TPU_DEBUG_DIR"] = dbg
        e = slo_engine(eng.model)
        token = f"serving.engine.{e.engine_id}"
        box = []
        detect_s = recovery_s = None
        with e:
            runner = threading.Thread(target=lambda: box.append(
                LoadGenerator(slo_traffic(rate), name="chaos_fault")
                .run_engine(e)), daemon=True)
            runner.start()
            time.sleep(min(1.0, SLO_DURATION / 4))      # traffic flowing
            t_fault = time.monotonic()
            fi.reset_injector(fi.FaultInjector(
                stall=CHAOS_STALL_S, stall_point="serving_decode"))
            try:
                while detect_s is None \
                        and time.monotonic() - t_fault < CHAOS_WAIT_S:
                    WATCHDOG.check_once()
                    if token in WATCHDOG.stalled():
                        detect_s = time.monotonic() - t_fault
                    time.sleep(0.05)
            finally:
                fi.reset_injector(fi.FaultInjector())
            t_cleared = time.monotonic()
            while recovery_s is None \
                    and time.monotonic() - t_cleared < CHAOS_WAIT_S:
                WATCHDOG.check_once()
                if token not in WATCHDOG.stalled():
                    recovery_s = time.monotonic() - t_fault
                time.sleep(0.05)
            runner.join(300)
            if not box or not box[0].wait(300):
                fail("chaos: the faulted replay did not finish")
        res = box[0]
        if detect_s is None:
            fail(f"chaos: the watchdog did not name {token} within "
                 f"{CHAOS_WAIT_S} s of the stall")
        if recovery_s is None:
            fail(f"chaos: {token} still stalled {CHAOS_WAIT_S} s after "
                 f"the stall cleared")
        check_load(res, eng.model.cfg.vocab_size, "chaos run_engine")
        bundles = [b for b in list_bundles(dbg)
                   if b.get("reason") == f"watchdog:{token}"]
        if not bundles or not bundles[0]["valid"]:
            fail(f"chaos: no valid watchdog bundle in {list_bundles(dbg)}")
        b = load_bundle(bundles[0]["path"], verify=True)
        snap = b["files"]["requests.json"].get(token)
        if not snap or "inflight" not in snap:
            fail(f"chaos: the bundle holds no requests snapshot of {token}")
        faulted = slo_report(res, gen="chaos_faulted")
        rec_off = (t_cleared + CHAOS_STALL_S) - res.started_at
        post = post_base = None
        if rec_off < SLO_DURATION - 0.5:
            post = slo_report(res, window=(rec_off, float("inf")),
                              gen="chaos_post")
            post_base = slo_report(base, window=(rec_off, float("inf")),
                                   gen="chaos_post_base")
        delta = None if post is None or post_base["attainment"] is None \
            else round(post_base["attainment"] - post["attainment"], 4)
        print(json.dumps({
            "phase": "chaos", "rate_rps": rate,
            "fault": f"stall@serving_decode {CHAOS_STALL_S}s",
            "watchdog_deadline_s": CHAOS_DEADLINE_S,
            "detect_s": round(detect_s, 3),
            "recovery_s": round(recovery_s, 3),
            "faulted_attainment": faulted["attainment"],
            "post_recovery_attainment": None if post is None
            else post["attainment"],
            "post_recovery_baseline": None if post_base is None
            else post_base["attainment"],
            "post_recovery_delta": delta,
            "faulted_goodput_tokens_per_sec":
                faulted["goodput_tokens_per_sec"],
            "bundle_files": sorted(b["files"]),
            "bundle_inflight": len(snap["inflight"]),
            "bundle_recent": len(snap.get("recent", []))}), flush=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(dbg, ignore_errors=True)


# the online phase: bench.py's bench_online part (1) (5 rounds of 3 pushes
# of 8 x 64 at a cadence of 3 steps), one 64-token greedy stream across
# each swap, bench_telemetry_overhead's / bench_tsdb's A/B/A at 60 steps a
# leg; the threshold rule the phase drives through its own gauge
ONLINE_ROUNDS, ONLINE_CADENCE, ONLINE_STREAM, ONLINE_STEPS = 5, 3, 64, 60
ONLINE_GAUGE = "paddle_tpu_chip_smoke_online_gauge"
ONLINE_RULE = {"name": "chip-smoke-online-gauge", "kind": "threshold",
               "metric": ONLINE_GAUGE, "op": ">", "value": 5.0,
               "for_s": 0.5, "resolve_s": 0.5, "severity": "warning"}
ONLINE_WAIT_S = 300.0


def wait_until(pred, what, timeout=60.0, every=0.05, phase="online"):
    """Polls pred() until it is true, or fails naming `phase` and
    `what`."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(every)
    fail(f"{phase}: {what} within {timeout} s")


def online_staleness(pub_dir):
    """Part (a), bench_online's part (1): a PSServer publishing to
    `pub_dir` every ONLINE_CADENCE applied pushes (PADDLE_TPU_TELEMETRY_HOST
    set by the caller, so it also hosts the collector of part (c));
    ONLINE_ROUNDS rounds of ONLINE_CADENCE pushes of 8 rows x 64; the time
    from the start of a round's last push to pub_latest answering the
    round's version over the shard's wire. Returns the running server."""
    import numpy as np
    from paddle_tpu_torch.distributed.fleet.runtime.parameter_server_runtime \
        import PSClient, PSServer
    from paddle_tpu_torch.publish import RegistryClient
    srv = PSServer("127.0.0.1:0", publish_dir=pub_dir,
                   publish_every_steps=ONLINE_CADENCE)
    srv.serve_in_thread()
    cl = PSClient([srv.endpoint])
    watcher = RegistryClient(srv.endpoint, timeout=30.0)
    rng = np.random.RandomState(0)
    stale = []
    try:
        for round_i in range(ONLINE_ROUNDS):
            for j in range(ONLINE_CADENCE):
                t0 = time.perf_counter()
                cl.push("emb", 64, np.arange(j * 8, j * 8 + 8),
                        rng.randn(8, 64))
            wait_until(lambda: watcher.latest()["latest"] >= round_i + 1,
                       f"PS publication {round_i + 1} on the wire",
                       every=0.002)
            stale.append(time.perf_counter() - t0)
        rec = watcher.latest()["record"]
        listed = watcher.list()
    finally:
        watcher.close()
        cl.close()
    if rec["kind"] != "ps-table" or rec["version"] != ONLINE_ROUNDS \
            or len(listed["versions"]) != ONLINE_ROUNDS:
        fail(f"online_staleness: registry {listed}")
    s = sorted(stale)
    print(json.dumps({
        "phase": "online_staleness", "rounds": ONLINE_ROUNDS,
        "cadence_steps": ONLINE_CADENCE, "push_rows": 8, "dim": 64,
        "staleness_p50_s": round(s[len(s) // 2], 6),
        "staleness_max_s": round(s[-1], 6),
        "staleness_s": [round(x, 6) for x in stale],
        "versions": ONLINE_ROUNDS, "digest": rec["digest"],
        "dedup_last": rec["extra"]["dedup"]}), flush=True)
    return srv


def toggle_ms(torch, eng, set_enabled, steps=ONLINE_STEPS):
    """bench.py's _bench_serving_toggle_overhead on `eng` (its own
    thread stopped): every slot busy, 5 warm steps, then `steps` decode
    steps timed on the host clock (the engine reads each step's tokens
    back, so a step's wall time holds its device time); A/B/A (on, off,
    on), with a leg of 20 first. Returns (on1, off, on2) ms a step."""
    import numpy as np
    rng = np.random.RandomState(0)
    vocab = eng.model.cfg.vocab_size

    def leg(n):
        reqs = [eng.submit(rng.randint(0, vocab, (16,)), n + 12)
                for _ in range(eng.num_slots)]
        for _ in range(5):
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n
        for r in reqs:
            eng.cancel(r)
        eng.run_until_idle()
        return dt * 1e3

    leg(20)
    on1 = leg(steps)
    set_enabled(False)
    try:
        off = leg(steps)
    finally:
        set_enabled(True)
    return on1, off, leg(steps)


def online_phase(torch, eng, first_tokens, root):
    """Item 17 on phase 3's GPT-3 XL engine `eng` and the store under
    `root` (the checkpoint phase's: publication dedups against it).
    (a) online_staleness; (b) online_swap: a Publisher over root's
    CheckpointStore behind a RegistryServer, a ServingServer(eng,
    publish_root=root) and a VersionSubscriber watching the registry over
    the wire; v1 = the same weights, v2 = one row of wte (the first
    prompt token's) moved one ulp up. Each version is published, read and
    uploaded by the subscriber off the step lock, and its flip held until
    a streamed greedy request (phase 3's first prompt, ONLINE_STREAM new
    tokens) is 4 frames in, so the flip lands inside the stream. Gates:
    v1 dedup 1.0 with 0 chunks written, v2 chunks written >= 1 and dedup
    >= 0.999, v2's parity digest not v1's, model_version following each
    adopt, the adopted wte row v2's, both streams contiguous with every
    token equal to the in-process reference (whose first len(first_tokens)
    tokens are phase 3's first request's), paged attention on the vector
    kernel and every decode sub-block launch on stream during (b).
    (c) online_telemetry: the process agent armed at the PS shard's
    hosted collector through (b): tel_fleet lists the engine's role, an
    assembled trace holds frontend.generate, the publish/swap flight
    events of v1 and v2 reach the collector, tsdb_query returns decode
    step samples, the JSON threshold rule on ONLINE_GAUGE goes pending ->
    firing -> resolved; then the agent's and the TSDB's A/B/A (no gate).
    Returns the launch counts of (b)."""
    import shutil
    import tempfile
    import threading
    import types
    from unittest import mock
    from paddle_tpu_torch.checkpoint import CheckpointStore
    from paddle_tpu_torch.distributed.fleet.runtime.rpc import RpcClient
    from paddle_tpu_torch.observability import REGISTRY
    from paddle_tpu_torch.observability import agent as tel_agent
    from paddle_tpu_torch.observability import gauge
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.publish import (Publisher, RegistryServer,
                                          VersionSubscriber, parity_digest)
    from paddle_tpu_torch.serving import ServingClient, ServingServer
    cfg = eng.model.cfg
    prompt = request_mix(cfg.vocab_size)[0][0]
    tok = int(prompt[0])
    written = REGISTRY.get("paddle_tpu_ckpt_chunks_written_total")
    work = tempfile.mkdtemp(prefix="chip_smoke_online_")
    rules = os.path.join(work, "rules.json")
    with open(rules, "w") as f:
        json.dump([ONLINE_RULE], f)

    # the in-process reference on the same engine and cache state
    ref = eng.submit(prompt, ONLINE_STREAM)
    eng.run_until_idle()
    want = ref.result().tolist()
    if want[:len(first_tokens)] != first_tokens:
        fail(f"online: the reference stream's first tokens {want} differ "
             f"from phase 3's {first_tokens}")

    # the shard's collector reads these when it is built; a streamed
    # generate's first span (frontend.generate) ends at its start and
    # the rest at its end, so the linger outlasts a stream
    with mock.patch.dict(os.environ, {
            "PADDLE_TPU_TELEMETRY_HOST": "1",
            "PADDLE_TPU_TELEMETRY_SAMPLE": "1.0",
            "PADDLE_TPU_TELEMETRY_LINGER": "5.0",
            "PADDLE_TPU_ALERTS_RULES": rules,
            "PADDLE_TPU_ALERTS_EVAL": "0.1"}):
        t0 = time.perf_counter()
        ps = online_staleness(os.path.join(work, "ps_pub"))
        part_a_s = time.perf_counter() - t0
    col = ps._tel_collector
    swap_events = []
    ingest = col.ingest

    def tap_ingest(batch):
        # the swap flight events carry no trace id, so the collector
        # keeps them in no trace: note their arrival in the pushes
        swap_events.extend(
            ev for ev in batch.get("flight") or ()
            if ev.get("tier") == "publish" and ev.get("kind") == "swap")
        return ingest(batch)

    col.ingest = tap_ingest
    hot = gauge(ONLINE_GAUGE, "the online phase's alert probe")
    hot.set(0.0)
    tel_agent.arm(ps.endpoint, role="online.engine", flush_s=0.2)
    store = CheckpointStore(root)
    pub = Publisher(root, store=store, run="chip_smoke")
    model = eng.model
    row0 = model.params["wte"][tok].clone()
    real_read, real_adopt = model.read_checkpoint, model.adopt_checkpoint
    swaps: dict[int, dict] = {}
    ready, go = threading.Event(), threading.Event()
    hook_errors = []

    def read_hook(r, step=None):
        sw = swaps.setdefault(int(step), {})
        t = time.perf_counter()
        prepared = real_read(r, step=step)
        torch.cuda.synchronize()
        sw["read_upload_s"] = time.perf_counter() - t
        ready.set()
        if not go.wait(ONLINE_WAIT_S):
            hook_errors.append(f"flip of {step} never released")
        sw["t_release"] = time.monotonic()
        return prepared

    def adopt_hook(prepared):
        # called under the step lock: the flip is the wait for the lock
        # (a decode step in flight) and the reference swap
        t = time.monotonic()
        out = real_adopt(prepared)
        for sw in swaps.values():
            if "t_release" in sw and "t_flip" not in sw:
                sw["t_flip"] = time.monotonic()
                sw["flip_s"] = sw["t_flip"] - sw["t_release"]
                sw["lock_wait_s"] = t - sw["t_release"]
                sw["swap_s"] = sw["t_flip"] - t
        return out

    model.read_checkpoint, model.adopt_checkpoint = read_hook, adopt_hook
    by_call = tap_sub_block_routes(model)
    rows = {}
    try:
        with RegistryServer(root, registry=pub.registry) as reg_srv, \
                ServingServer(eng, "127.0.0.1:0", publish_root=root) as srv:
            sub = VersionSubscriber(root, engine=eng,
                                    registry=pub.registry,
                                    endpoint=reg_srv.endpoint)
            sub.start()
            cli = ServingClient(srv.endpoint)
            reset_launch_counts()
            try:
                for version in (1, 2):
                    params = model.params
                    if version == 2:        # one row, one ulp up
                        params = dict(params)
                        wte = params["wte"].clone()
                        wte[tok] = torch.nextafter(
                            wte[tok], torch.full_like(wte[tok], math.inf))
                        params["wte"] = wte
                        row2 = wte[tok].clone()
                    ready.clear()
                    go.clear()
                    w0 = written.value
                    t = time.perf_counter()
                    rec = pub.publish_model(types.SimpleNamespace(
                        params=params, cfg=cfg), step=version)
                    pub_s = time.perf_counter() - t
                    del params
                    new_chunks = int(written.value - w0)
                    if rec["version"] != version:
                        fail(f"online: published {rec}, expected version "
                             f"{version}")
                    if not ready.wait(ONLINE_WAIT_S):
                        fail(f"online: the subscriber never read version "
                             f"{version} (failed {sub.failed_versions})")
                    frames, rep = [], {}

                    def stream():
                        try:
                            rep.update(cli.generate(
                                prompt, ONLINE_STREAM, timeout=ONLINE_WAIT_S,
                                stream=True, on_token=lambda toks, idx:
                                frames.append((time.monotonic(), idx,
                                               [int(x) for x in toks]))))
                        except Exception as e:
                            rep["error"] = f"{type(e).__name__}: {e}"

                    th = threading.Thread(target=stream)
                    th.start()
                    deadline = time.monotonic() + ONLINE_WAIT_S
                    while len(frames) < 4 and th.is_alive() \
                            and time.monotonic() < deadline:
                        time.sleep(0.001)
                    go.set()
                    th.join(ONLINE_WAIT_S)
                    wait_until(lambda: sub.current_version == version,
                               f"adopting version {version}",
                               timeout=ONLINE_WAIT_S)
                    if hook_errors:
                        fail(f"online: {hook_errors}")
                    rows[version] = (rec, pub_s, new_chunks, frames, rep,
                                     swaps[version])
                    if version == 1:
                        digest1 = rec["digest"]
                stats = cli.stats()
            finally:
                cli.close()
                sub.stop()
        counts = launch_counts()
    finally:
        for name in ("read_checkpoint", "adopt_checkpoint", "prefill",
                     "prefill_tail", "decode"):
            if name in vars(model):
                delattr(model, name)

    for version, (rec, pub_s, new_chunks, frames, rep, sw) in rows.items():
        toks, idx_ok = [], True
        for _t, idx, ts in frames:
            idx_ok &= idx == len(toks)
            toks.extend(ts)
        if rep.get("status") != "done" or not idx_ok \
                or len(toks) != ONLINE_STREAM \
                or toks != list(rep["tokens"]):
            fail(f"online: the stream across v{version} lost, doubled or "
                 f"reordered tokens: {rep.get('status')} "
                 f"{rep.get('error')} frames {[f[1] for f in frames]}")
        gaps_in, gaps_out = [], []
        for (a, _i, _x), (b, _j, _y) in zip(frames, frames[1:]):
            inside = sw["t_release"] <= b <= sw["t_flip"] + 0.05
            (gaps_in if inside else gaps_out).append(b - a)
        dedup = rec["extra"]["dedup"]
        row = {"phase": "online_swap", "version": version,
               "change": "none" if version == 1 else
               f"wte row {tok} one ulp up",
               "publish_s": round(pub_s, 3), "chunks_written": new_chunks,
               "dedup": dedup, "digest": rec["digest"],
               "read_upload_s": round(sw["read_upload_s"], 3),
               "flip_s": round(sw["flip_s"], 6),
               "flip_lock_wait_s": round(sw["lock_wait_s"], 6),
               "flip_swap_s": round(sw["swap_s"], 6),
               "flip_window_max_gap_ms": round(max(gaps_in) * 1e3, 3)
               if gaps_in else None,
               "stream_median_gap_ms": round(
                   statistics.median(gaps_out) * 1e3, 3)
               if gaps_out else None,
               "stream_frames": len(frames),
               "tokens_equal_reference": toks == want}
        print(json.dumps(row), flush=True)
        if version == 1 and (new_chunks or dedup != 1.0
                             or toks != want):
            fail(f"online: v1 (the same weights) wrote {new_chunks} chunks, "
                 f"dedup {dedup}, tokens equal {toks == want}")
        if version == 2:
            if new_chunks < 1 or dedup < 0.999 \
                    or rec["digest"] == digest1 \
                    or parity_digest(store.latest_manifest(2)) \
                    != rec["digest"]:
                fail(f"online: v2 wrote {new_chunks} chunks, dedup {dedup}, "
                     f"digest {rec['digest']} (v1 {digest1})")
            live = model.params["wte"][tok]
            if not torch.equal(live, row2) or torch.equal(live, row0):
                fail("online: the engine does not serve v2's wte row")
    if stats.get("model_version") != 2 \
            or eng.stats()["model_version"] != 2:
        fail(f"online: model_version {stats.get('model_version')} after "
             f"adopting v2")
    print(json.dumps({"phase": "online_launches", "launches": counts,
                      "sub_block_routes": by_call}), flush=True)
    if counts.get("paged_attention", 0) <= 0 \
            or counts.get("paged_attention.vector", 0) \
            != counts["paged_attention"] \
            or not by_call.get("decode") \
            or any(not k.endswith(".stream") for k in by_call["decode"]):
        fail(f"online: decode launches off vector / stream: {counts} "
             f"{by_call}")

    # (c) the telemetry plane, read over the shard's wire
    t0 = time.perf_counter()
    ag = tel_agent.get_agent()
    rc = RpcClient(ps.endpoint, timeout=30.0)
    try:
        ag.flush_once()
        fleet = rc.call({"op": "tel_fleet"})["fleet"]
        roles = sorted({p["role"] for p in fleet["procs"]})
        if "online.engine" not in roles:
            fail(f"online_telemetry: tel_fleet roles {roles}")
        found = {}

        def traced():
            # a kept trace of a wire generate: the server's span and the
            # front end's under one trace id
            for t in rc.call({"op": "tel_traces", "limit": 256})["traces"]:
                tr = rc.call({"op": "tel_trace",
                              "trace_id": t["trace_id"]})["trace"] or {}
                names = {s["name"] for s in tr.get("spans", ())}
                if {"rpc.server.generate", "frontend.generate"} <= names:
                    found.update(tr)
                    return True
            return False

        wait_until(traced, "an assembled trace of a wire generate",
                   timeout=30.0, every=0.5)
        wait_until(lambda: {1, 2} <= {int(e["attrs"]["version"])
                                      for e in swap_events},
                   "the publish/swap flight events of v1 and v2",
                   timeout=30.0)
        q = {"op": "tsdb_query", "metric":
             "paddle_tpu_serving_decode_step_seconds",
             "labels": {"role": "online.engine"}, "window": 600}
        pts = rc.call(dict(q, query="range"))["points"]
        if not pts or not any(s["points"] for s in pts):
            fail(f"online_telemetry: no decode-step samples in the TSDB "
                 f"({pts})")
        p50 = rc.call(dict(q, query="quantile", q=0.5))["value"]
        hot.set(10.0)
        wait_until(lambda: any(
            a["rule"] == ONLINE_RULE["name"] and a["state"] == "firing"
            for a in rc.call({"op": "alerts"})["alerts"]["active"]),
            "the gauge rule firing", timeout=30.0, every=0.1)
        hot.set(0.0)
        wait_until(lambda: rc.call({"op": "alerts"})["alerts"]["counts"][
            "resolved"] >= 1, "the gauge rule resolving", timeout=30.0,
            every=0.1)
        # the collector's own mirror of the transitions (the agent's
        # copies of firing / resolved arrive under the engine's role)
        seen = [e["kind"] for e in rc.call({"op": "tel_fleet"})[
            "fleet"]["recent_events"]
            if e["kind"].startswith("alert_") and e["role"] == "collector"
            and e["attrs"].get("rule") == ONLINE_RULE["name"]]
        if seen[:3] != ["alert_pending", "alert_firing", "alert_resolved"]:
            fail(f"online_telemetry: alert lifecycle {seen}")
        usage = rc.call({"op": "usage_report"})["usage"]
    finally:
        rc.close()
    checks_s = time.perf_counter() - t0
    paused = []

    def tsdb_on(on):
        if on:
            col.tsdb, col.alerts = paused.pop()
        else:
            paused.append((col.tsdb, col.alerts))
            col.tsdb = col.alerts = None

    def agent_on(on):
        # the agent at its default flush, as bench_telemetry_overhead
        if on:
            tel_agent.arm(ps.endpoint, role="online.engine")
        else:
            tel_agent.disarm()

    try:
        agent_on(True)
        a_on1, a_off, a_on2 = toggle_ms(torch, eng, agent_on)
        t_on1, t_off, t_on2 = toggle_ms(torch, eng, tsdb_on)
    finally:
        tel_agent.disarm()
        col.ingest = ingest
        ps.shutdown()
        ps.server_close()
        shutil.rmtree(work, ignore_errors=True)

    def pct(on1, off, on2):
        return round((min(on1, on2) - off) / off * 100, 2)

    print(json.dumps({
        "phase": "online_telemetry", "fleet_roles": roles,
        "trace": {"trace_id": found.get("trace_id"),
                  "verdict": found.get("verdict"),
                  "spans": [s["name"] for s in found["spans"]],
                  "roles": sorted({s["role"] for s in found["spans"]}),
                  "duration_ms": found.get("duration_ms")},
        "swap_events": sorted(int(e["attrs"]["version"])
                              for e in swap_events),
        "tsdb_decode_step_series": len(pts),
        "tsdb_decode_step_p50_s": p50,
        "alert_lifecycle": seen[:3],
        "usage_tenants": sorted(usage.get("tenants", {})),
        "part_a_s": round(part_a_s, 2), "checks_s": round(checks_s, 2),
        "agent_step_ms": {"on": [round(a_on1, 3), round(a_on2, 3)],
                          "off": round(a_off, 3),
                          "overhead_pct": pct(a_on1, a_off, a_on2)},
        "tsdb_step_ms": {"on": [round(t_on1, 3), round(t_on2, 3)],
                         "off": round(t_off, 3),
                         "overhead_pct": pct(t_on1, t_off, t_on2)},
        "steps_a_leg": ONLINE_STEPS, "slots": eng.num_slots,
        "bar_pct": 2.0}), flush=True)
    return counts


def online_alone(torch):
    """--online: phase 3's GPT-3 XL engine (seed-0 weights, its slots,
    pool and prefix cache) serving phase 3's first request cold, its
    weights saved under a temporary root, then online_phase on both; the
    root is removed at the end."""
    import shutil
    import tempfile
    from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    from paddle_tpu_torch.serving import GPTDecodeModel
    cfg = GPTConfig.gpt3_1p3b()
    t0 = time.perf_counter()
    eng = serving_engine(GPTDecodeModel(cfg, params=init_gpt_params(
        cfg, seed=0)), prefix_cache_pages=64)
    p, n, kw = request_mix(cfg.vocab_size)[0]
    first = eng.submit(p, n, **kw)
    eng.run_until_idle()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        eng.model.save_checkpoint(root)
        print(json.dumps({"phase": "online_store", "config": "gpt3_1p3b",
                          "seconds": round(time.perf_counter() - t0, 2)}),
              flush=True)
        timed("online", online_phase, torch, eng, first.result().tolist(),
              root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the router phase: bench.py's bench_router (its probe settings, lines
# 1127-1131, and its kill at 2.5 s) and bench_online's part (2) (64-token
# streams through a staggered rollout). A run lasts at least 8 s and 5 s
# past the killed replica's predicted re-admission
ROUTER_PROBE = dict(ping_interval=0.2, ping_timeout=1.0, suspect_after=1,
                    dead_after=2, token_stall=5.0, respawn_cooldown=0.5)
ROUTER_KILL_AT, ROUTER_MIN_RUN_S, ROUTER_AFTER_S = 2.5, 8.0, 5.0
ROUTER_WAIT_S = 120.0
ROUTER_TAP = ("paged_attention", "fused_out_ln.", "fused_ffn_ln.")


def router_series(router, name):
    """{label: value} of the router metric `name`'s series of `router`
    (the label after the router id: an outcome, a reason, a replica)."""
    from paddle_tpu_torch.observability import REGISTRY
    return {lv[1]: s.value for lv, s in REGISTRY.get(name)._series()
            if lv[0] == router.router_id}


def series_delta(now, before):
    return {k: int(v - before.get(k, 0)) for k, v in now.items()
            if v != before.get(k, 0)}


class FleetWatch:
    """Samples the router's view of its replicas every 20 ms on a thread
    of its own: each replica's largest in-flight count and its seconds
    out of the healthy state."""

    def __init__(self, router):
        self.router = router
        self.peak: dict = {}
        self.down: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        t_last = time.monotonic()
        while not self._stop.wait(0.02):
            now = time.monotonic()
            for n, r in self.router.stats()["replicas"].items():
                self.peak[n] = max(self.peak.get(n, 0), r["inflight"])
                if r["state"] != "healthy":
                    self.down[n] = self.down.get(n, 0.0) + now - t_last
            t_last = now

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(10)
        return {"peak_inflight": dict(self.peak),
                "not_healthy_s": {n: round(v, 3)
                                  for n, v in self.down.items()}}


def routes_prefills(taps, layers):
    """Prefill calls of 128 rows or more (the rollout's streams and the
    in-process reference after it) in a replica's by-call tallies."""
    from paddle_tpu_torch.ops.fused_block import _FFMA_MIN_ROWS
    return sum(t.get(f"prefill_ge_{_FFMA_MIN_ROWS}", {}).get(
        "fused_out_ln.ffma", 0) for t in taps) // layers


def check_replica_routes(name, taps):
    """A replica's decode calls launched paged attention on the vector
    kernel and the sub-blocks on stream, and nothing else; its prefill
    calls' sub-blocks took their rows' route. `taps` are the by-call
    launch tallies of its engines (one a life)."""
    from paddle_tpu_torch.ops.fused_block import (_FFMA_MIN_ROWS,
                                                  _STREAM_MAX_ROWS)
    want = {"decode": "stream", f"prefill_le_{_STREAM_MAX_ROWS}": "stream",
            f"prefill_lt_{_FFMA_MIN_ROWS}": "simt",
            f"prefill_ge_{_FFMA_MIN_ROWS}": "ffma"}
    merged: dict = {}
    for by_call in taps:
        for kind, ent in by_call.items():
            for k, v in ent.items():
                merged.setdefault(kind, {})[k] = \
                    merged.setdefault(kind, {}).get(k, 0) + v
    dec = merged.get("decode", {})
    if not dec.get("paged_attention") \
            or dec.get("paged_attention.vector") != dec["paged_attention"] \
            or not any(k.startswith("fused_") for k in dec):
        fail(f"router: replica {name}'s decode launches {dec}")
    for kind, ent in merged.items():
        bad = {k: v for k, v in ent.items() if k.startswith("fused_")
               and not k.endswith(f".{want[kind]}")}
        if bad:
            fail(f"router: replica {name}'s {kind} launches {bad}, all "
                 f"expected on the {want[kind]} route")
    return merged


def router_streams(cli, prompt, stop, out):
    """Streams of ONLINE_STREAM greedy tokens of `prompt`, one after
    another through `cli`, until `stop` is set; each appended to `out`
    when it starts as (start time, frames [(arrival time, index,
    tokens)], final reply: filled when it ends)."""
    while not stop.is_set():
        frames, rep = [], {}
        out.append((time.monotonic(), frames, rep))
        try:
            rep.update(cli.generate(
                prompt, ONLINE_STREAM, timeout=ROUTER_WAIT_S, stream=True,
                on_token=lambda toks, idx: frames.append(
                    (time.monotonic(), idx, [int(x) for x in toks]))))
        except Exception as e:
            rep.update(status="exception", error=f"{type(e).__name__}: {e}")


def router_phase(torch, eng, root, rate, wire, versions):
    """The replicated-serving router (item 18's rest) at GPT-3 XL width
    over two replicas on the card. Replica A: a fresh engine with phase
    3's slots and pool on phase 3's weights (eng.model: no second upload)
    behind a ServingServer with publish_root=`root`, warmed as slo_engine;
    replica B: InProcessReplica(root) built from store step versions[0]
    (Engine.from_checkpoint: a read and upload), warmed alike. Neither
    keeps a prefix cache, so a request replayed between runs prefills as
    it did the first time. A Router with bench_router's probe settings
    fronts them; before any traffic both must report the same
    model_version. (a) bench_router over the wire through the router
    (router_drill): slo_traffic for max(8 s, B's predicted re-admission
    + 5 s) with no fault, then the same with B killed (listener and live
    connections severed, decode halted) 2.5 s in and respawned from its
    checkpoint by the router: detect s (kill -> B not healthy), recovery
    s (kill -> the respawned B healthy), failovers, attainment
    (baseline, faulted, after recovery beside the baseline's same
    window), wire TTFT and inter-token p50 / p99 beside the slo phase's
    (`wire`, its run_client row at `rate`). The rate starts at half the
    slo phase's held `rate` (two GPT-3 XL decode loops, the router and
    the clients share one process and its GIL: a replica's decode step
    took 3.6-4.4x the lone engine's, and at the full rate the survivor
    could not take the dead replica's streams) and halves, each attempt
    printed, while the faulted run has any outcome but "done", down to
    SLO_MIN_RATE. Gates, on the last attempt: no request error and no
    token out of range, every request done in both runs the same
    tokens, one final reply a request. (b) bench_online's part
    (2): router.rollout_version(versions[1]), a version already published
    that neither serves, while streams of ONLINE_STREAM tokens of phase
    3's first prompt run back to back through the router: the rollout's
    wall s, each replica's read + upload s and flip ms, the largest
    inter-token gap inside each flip window beside the streams' median,
    `adopted` and both replicas' model_version after. Gates: every
    stream whole (no frame lost or repeated, its tokens the final
    reply's), a stream that ended before the first flip equal to the
    in-process tokens on the old weights and one that began after the
    last flip to those on the new, one final reply a stream, both
    replicas on versions[1]. Each replica's decode launches on the
    vector / stream kernels (its own thread's launches, tapped per
    engine). Returns the launch counts of (a) and (b) (set to 0 just
    before the first run's traffic)."""
    import numpy as np
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.serving import (InProcessReplica, ReplicaSpec,
                                          Router, ServingClient,
                                          ServingServer)
    cur, target = versions
    vocab = eng.model.cfg.vocab_size
    prompt = request_mix(vocab)[0][0]
    t_phase = time.perf_counter()
    a_eng = slo_engine(eng.model)
    ref = a_eng.submit(prompt, ONLINE_STREAM)
    a_eng.run_until_idle()
    want_cur = ref.result().tolist()
    taps = {"A": [tap_sub_block_routes(a_eng.model, ROUTER_TAP)], "B": []}
    rep_b = InProcessReplica(root, name="B", publish_root=root, engine_kw=dict(
        step=cur, num_slots=8, num_pages=SERVE_PAGES, page_size=SERVE_PAGE))
    lives = []

    def start_b(respawn):
        t = time.perf_counter()
        ep = rep_b.respawn() if respawn else rep_b.start()
        torch.cuda.synchronize()
        lives.append(round(time.perf_counter() - t, 3))
        taps["B"].append(tap_sub_block_routes(rep_b.engine.model,
                                              ROUTER_TAP))
        return ep

    srv_a = router = None
    models = [a_eng.model]
    try:
        start_b(False)
        for plen in (4, 8, 16, 32):     # slo_engine's warm-up, live
            rep_b.engine.generate(np.full((plen,), 1, np.int32), 2,
                                  timeout=ROUTER_WAIT_S)
        models.append(rep_b.engine.model)
        srv_a = ServingServer(a_eng, "127.0.0.1:0", publish_root=root).start()
        router = Router("127.0.0.1:0", publish_root=root, replicas=[
            ReplicaSpec("A", srv_a.endpoint),
            ReplicaSpec("B", rep_b.endpoint,
                        respawn=lambda: start_b(True))],
            **ROUTER_PROBE)
        router.start()
        wait_until(lambda: router.stats()["healthy_replicas"] == 2,
                   "both replicas healthy", timeout=ROUTER_WAIT_S,
                   phase="router")
        start_versions = {n: r["last_info"].get("model_version")
                          for n, r in router.stats()["replicas"].items()}
        if len(set(start_versions.values())) != 1:
            fail(f"router: the replicas serve other versions "
                 f"{start_versions}")
        setup_s = time.perf_counter() - t_phase

        # (a) failover and respawn, from half the slo phase's rate,
        # halving while the survivor cannot hold it
        reset_launch_counts()
        drill_rate = rate / 2
        while True:
            row, problems = router_drill(router, a_eng, rep_b, lives,
                                         drill_rate, wire, vocab)
            row.update(setup_s=round(setup_s, 3),
                       start_model_version=start_versions)
            print(json.dumps(row), flush=True)
            held = set(row["router_outcomes"][1]) == {"done"}
            if held or drill_rate / 2 < SLO_MIN_RATE:
                break
            drill_rate /= 2
        models.append(rep_b.engine.model)
        if problems:
            fail(f"router: {problems}")

        # (b) the staggered rollout under back-to-back streams
        swaps: dict = {}
        b_eng = rep_b.engine
        for name, e in (("A", a_eng), ("B", b_eng)):
            m = e.model
            read, upload = m.read_checkpoint, m._prepare_params
            adopt = m.adopt_checkpoint

            def read_hook(r, step=None, _n=name, _read=read):
                swaps[_n] = {"t_read": time.monotonic()}
                prepared = _read(r, step=step)
                torch.cuda.synchronize()
                swaps[_n]["t_release"] = time.monotonic()
                return prepared

            def upload_hook(arrays, r, _n=name, _upload=upload):
                swaps[_n]["t_upload"] = time.monotonic()
                return _upload(arrays, r)

            def adopt_hook(prepared, _n=name, _adopt=adopt):
                out = _adopt(prepared)
                swaps[_n]["t_flip"] = time.monotonic()
                return out

            m.read_checkpoint, m.adopt_checkpoint = read_hook, adopt_hook
            m._prepare_params = upload_hook
        stop = threading.Event()
        streams: list = []
        cli = ServingClient(router.endpoint)
        answers0 = router_series(router, "paddle_tpu_router_requests_total")
        streamer = threading.Thread(target=router_streams, daemon=True,
                                    args=(cli, prompt, stop, streams))
        try:
            streamer.start()
            wait_until(lambda: streams and len(streams[0][1]) >= 4,
                       "a stream under way", timeout=ROUTER_WAIT_S,
                       phase="router")
            t = time.perf_counter()
            out = router.rollout_version(target)
            rollout_s = time.perf_counter() - t
            # on until a stream begun after the last flip has ended
            t_done = time.monotonic()
            wait_until(lambda: any(t0 > t_done and rep
                                   for t0, _f, rep in streams),
                       "a whole stream after the rollout",
                       timeout=ROUTER_WAIT_S, phase="router")
            stop.set()
            streamer.join(ROUTER_WAIT_S)
            if streamer.is_alive():
                fail("router: the streams did not end")
        finally:
            stop.set()
            cli.close()
        stream_answers = sum(series_delta(router_series(
            router, "paddle_tpu_router_requests_total"), answers0).values())
        after = {n: r["last_info"].get("model_version")
                 for n, r in router.stats()["replicas"].items()}
        engines = {"A": a_eng.stats()["model_version"],
                   "B": b_eng.stats()["model_version"]}
        if out.get("adopted") != target or set(after.values()) != {target} \
                or set(engines.values()) != {target} or set(swaps) != {"A", "B"}:
            fail(f"router: rollout {out}, replicas on {after} / {engines}")
        ref = a_eng.submit(prompt, ONLINE_STREAM)
        want_target = ref.result(ROUTER_WAIT_S).tolist()
        first_flip = min(sw["t_read"] for sw in swaps.values())
        last_flip = max(sw["t_flip"] for sw in swaps.values())
        # a gap is the wait for a frame, counted in the window (read,
        # upload, flip of a replica) in which that frame arrived
        windows = {(n, w): (sw[t0], sw[t1] + (0.05 if w == "flip" else 0))
                   for n, sw in swaps.items()
                   for w, t0, t1 in (("read", "t_read", "t_upload"),
                                     ("upload", "t_upload", "t_release"),
                                     ("flip", "t_release", "t_flip"))}
        gaps_in = {k: [] for k in windows}
        gaps_out, equal = [], []
        for t0, frames, rep in streams:
            toks, idx_ok = [], True
            for _t, idx, ts in frames:
                idx_ok &= idx == len(toks)
                toks.extend(ts)
            final = [int(x) for x in np.asarray(rep.get("tokens", ())).ravel()]
            if rep.get("status") != "done" or not idx_ok \
                    or len(toks) != ONLINE_STREAM or toks != final:
                fail(f"router: a stream lost, doubled or reordered tokens: "
                     f"{rep.get('status')} {rep.get('error')} frames "
                     f"{[f[1] for f in frames]}")
            end = frames[-1][0]
            if end < first_flip and toks != want_cur \
                    or t0 > last_flip and toks != want_target:
                fail("router: a stream's tokens differ from the in-process "
                     "tokens on its weights")
            equal.append(toks in (want_cur, want_target))
            for (a, _i, _x), (b, _j, _y) in zip(frames, frames[1:]):
                inside = [k for k, (lo, hi) in windows.items()
                          if lo <= b <= hi]
                for k in inside:
                    gaps_in[k].append(b - a)
                if not inside:
                    gaps_out.append(b - a)
        if stream_answers != len(streams):
            fail(f"router: {stream_answers} final replies for "
                 f"{len(streams)} streams")
        routes = {n: check_replica_routes(n, taps[n]) for n in ("A", "B")}
        counts = launch_counts()
        print(json.dumps({
            "phase": "router_rollout", "version_from": cur,
            "version_to": target, "adopted": out.get("adopted"),
            "replicas": out.get("replicas"), "model_version_after": after,
            "rollout_s": round(rollout_s, 3),
            "read_upload_s": {n: round(sw["t_release"] - sw["t_read"], 3)
                              for n, sw in swaps.items()},
            "upload_s": {n: round(sw["t_release"] - sw["t_upload"], 3)
                         for n, sw in swaps.items()},
            "flip_ms": {n: round((sw["t_flip"] - sw["t_release"]) * 1e3, 3)
                        for n, sw in swaps.items()},
            "window_max_gap_ms": {
                f"{n}.{w}": round(max(g) * 1e3, 3) if g else None
                for (n, w), g in gaps_in.items()},
            "long_prefills": {n: routes_prefills(
                taps[n], a_eng.model.cfg.num_layers) for n in ("A", "B")},
            "stream_median_gap_ms": round(statistics.median(gaps_out) * 1e3,
                                          3) if gaps_out else None,
            "streams": len(streams), "final_replies": int(stream_answers),
            "old_equals_new_weights_tokens": want_cur == want_target,
            "streams_equal_reference": sum(equal)}), flush=True)
        print(json.dumps({"phase": "router_launches", "launches": counts,
                          "replica_routes": routes,
                          "phase_s": round(time.perf_counter() - t_phase,
                                           2)}), flush=True)
        if counts.get("paged_attention.vector", 0) \
                != counts.get("paged_attention", 0):
            fail(f"router: paged attention off the vector kernel {counts}")
        return counts
    finally:
        if router is not None:
            router.stop()
        if srv_a is not None:
            srv_a.stop()
        rep_b.stop()
        for m in models:
            for name in ("read_checkpoint", "adopt_checkpoint", "prefill",
                         "prefill_tail", "decode"):
                if name in vars(m):
                    delattr(m, name)


def router_drill(router, a_eng, rep_b, lives, rate, wire, vocab):
    """router_phase's part (a) at `rate`: slo_traffic for max(8 s, B's
    predicted re-admission + 5 s) through `router`, fault-free, then again
    with B killed ROUTER_KILL_AT s in (on a thread: detection is timed
    from the kill's start) and respawned by the router. Returns the
    row to print and the gates' failures (none: every gate met)."""
    from paddle_tpu_torch.serving import (LoadGenerator, ServingClient,
                                          slo_report)
    # B's respawn runs beside a loaded survivor: 1.5-1.8x its idle start
    # on an H100 (PERF.md, the router runs), then a probe re-admits it
    predicted = 2 * lives[-1] + 1.0
    run_s = max(ROUTER_MIN_RUN_S, predicted + ROUTER_AFTER_S)
    traffic = slo_traffic(rate, duration=run_s)
    cli = ServingClient(router.endpoint)
    outcomes, reasons, watched = [], [], []
    try:
        out0 = router_series(router, "paddle_tpu_router_requests_total")
        watch = FleetWatch(router)
        marks = [decode_mark(e) for e in (a_eng, rep_b.engine)]
        base = LoadGenerator(traffic, name="router_base").run_client(
            cli, timeout=ROUTER_WAIT_S)
        if not base.wait(300):
            fail("router: the fault-free run did not finish")
        step_ms = [decode_ms_since(e, m) for e, m in
                   zip((a_eng, rep_b.engine), marks)]
        watched.append(watch.stop())
        out1 = router_series(router, "paddle_tpu_router_requests_total")
        outcomes.append(series_delta(out1, out0))
        fo0 = router_series(router, "paddle_tpu_router_failovers_total")
        box = []
        watch = FleetWatch(router)
        runner = threading.Thread(target=lambda: box.append(
            LoadGenerator(traffic, name="router_fault").run_client(
                cli, timeout=ROUTER_WAIT_S)), daemon=True)
        runner.start()
        time.sleep(ROUTER_KILL_AT)
        # the kill (listener, connections, then the decode loop) on
        # a thread of its own: detection is timed from its start
        killer = threading.Thread(target=rep_b.kill, daemon=True)
        epoch = router.stats()["replicas"]["B"]["epoch"]
        t_kill = time.monotonic()
        killer.start()
        detect_s = recovery_s = None
        while time.monotonic() - t_kill < ROUTER_WAIT_S \
                and recovery_s is None:
            st = router.stats()["replicas"]["B"]
            now = time.monotonic()
            if detect_s is None and st["state"] != "healthy":
                detect_s = now - t_kill
            if detect_s is not None and st["state"] == "healthy" \
                    and st["epoch"] > epoch:
                recovery_s = now - t_kill
            time.sleep(0.01)
        killer.join(60)
        runner.join(300)
        if not box or not box[0].wait(300):
            fail("router: the faulted run did not finish")
        fault = box[0]
        watched.append(watch.stop())
        outcomes.append(series_delta(router_series(
            router, "paddle_tpu_router_requests_total"), out1))
        reasons = series_delta(router_series(
            router, "paddle_tpu_router_failovers_total"), fo0)
    finally:
        cli.close()
    want = {a.index: [int(t) for t in h.generated]
            for a, h in base.handles if h.status == "done"}
    got = {a.index: [int(t) for t in h.generated]
           for a, h in fault.handles if h.status == "done"}
    differ = sorted(i for i in set(want) & set(got) if want[i] != got[i])
    rep_base, rep_fault = slo_report(base), slo_report(fault)
    rec_off = None if recovery_s is None \
        else t_kill + recovery_s - fault.started_at
    post = post_base = None
    if rec_off is not None and rec_off < run_s - 0.5:
        post = slo_report(fault, window=(rec_off, float("inf")),
                          gen="router_post")
        post_base = slo_report(base, window=(rec_off, float("inf")),
                               gen="router_post_base")
    delta = None if post is None or post_base["attainment"] is None \
        or post["attainment"] is None \
        else round(post_base["attainment"] - post["attainment"], 4)
    row = {
        "phase": "router_failover", "rate_rps": rate,
        "duration_s": run_s, "kill_at_s": ROUTER_KILL_AT,
        "replica_start_s": list(lives),
        "baseline_decode_step_ms": {n: list(v) for n, v in
                                    zip("AB", step_ms)},
        "fleet": watched,
        "predicted_recovery_s": round(predicted, 3),
        "detect_s": None if detect_s is None else round(detect_s, 3),
        "recovery_s": None if recovery_s is None
        else round(recovery_s, 3),
        "failovers": reasons, "requests": len(fault.handles),
        "done_in_both": len(set(want) & set(got)),
        "router_outcomes": outcomes,
        "baseline_attainment": rep_base["attainment"],
        "faulted_attainment": rep_fault["attainment"],
        "post_recovery_attainment": None if post is None
        else post["attainment"],
        "post_recovery_baseline": None if post_base is None
        else post_base["attainment"],
        "post_recovery_delta": delta,
        "wire_ttft_ms": [rep_base["ttft_ms_p50"],
                         rep_base["ttft_ms_p99"]],
        "wire_itl_ms": [rep_base["itl_ms_p50"], rep_base["itl_ms_p99"]],
        "faulted_ttft_ms": [rep_fault["ttft_ms_p50"],
                            rep_fault["ttft_ms_p99"]],
        "slo_wire_ttft_ms": None if wire is None
        else [wire["ttft_ms_p50"], wire["ttft_ms_p99"]],
        "slo_wire_itl_ms": None if wire is None
        else [wire["itl_ms_p50"], wire["itl_ms_p99"]],
        "by_status": [rep_base["by_status"], rep_fault["by_status"]]}
    problems = []
    if detect_s is None or recovery_s is None:
        problems.append(f"B detected {detect_s}, recovered {recovery_s} "
                        f"within {ROUTER_WAIT_S} s of the kill")
    for res, what in ((base, "fault-free"), (fault, "faulted")):
        problems += load_problems(res, vocab, f"the {what} run")
    replies = [sum(o.values()) for o in outcomes]
    if replies != [len(base.handles), len(fault.handles)]:
        problems.append(f"{replies} final replies for {len(base.handles)} "
                        f"/ {len(fault.handles)} requests")
    if differ or not got:
        problems.append(f"{len(got)} requests done in the faulted run, "
                        f"tokens differ from the fault-free run on "
                        f"{differ[:8]}")
    return row, problems



def publish_versions(torch, eng, root):
    """--router's store: phase 3's weights published as version 1 (every
    chunk written) and again as version 2 (every chunk a dedup hit) under
    `root`, and `eng` warm-started onto version 2, as the online phase
    leaves them. Returns (2, 1): the version served, the one to roll
    out."""
    import types
    from paddle_tpu_torch.publish import Publisher
    pub = Publisher(root, run="chip_smoke")
    model = types.SimpleNamespace(params=eng.model.params,
                                  cfg=eng.model.cfg)
    t = time.perf_counter()
    for version in (1, 2):
        rec = pub.publish_model(model, step=version)
        if rec["version"] != version:
            fail(f"router: published {rec}, expected version {version}")
    pub_s = time.perf_counter() - t
    t = time.perf_counter()
    eng.warm_start(root, step=2, version=2)
    print(json.dumps({"phase": "router_store", "publish_s": round(pub_s, 2),
                      "warm_start_s": round(time.perf_counter() - t, 3)}),
          flush=True)
    return 2, 1


def router_alone(torch):
    """--router: phase 3's GPT-3 XL engine (seed-0 weights) serving phase
    3's first request cold, the slo phase for its held rate and wire
    figures, two versions published under a temporary root and the
    engine on the second (publish_versions), then router_phase; the root
    is removed at the end."""
    import shutil
    import tempfile
    from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    from paddle_tpu_torch.serving import GPTDecodeModel
    cfg = GPTConfig.gpt3_1p3b()
    eng = serving_engine(GPTDecodeModel(cfg, params=init_gpt_params(
        cfg, seed=0)), prefix_cache_pages=64)
    p, n, kw = request_mix(cfg.vocab_size)[0]
    eng.submit(p, n, **kw)
    eng.run_until_idle()
    rate, _res, wire = timed("slo", slo_phase, torch, eng)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        versions = timed("router_store", publish_versions, torch, eng, root)
        return timed("router", router_phase, torch, eng, root, rate, wire,
                     versions)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# fault C7: two threads launching the decode sub-blocks on one stream
C7_REPS = 300


def check_two_threads(torch):
    """Fault C7 (ROADMAP C): two engines in one process decode on their
    own threads, and both enqueue on the one stream. Two threads,
    released together, each with its own inputs at decode (M = 8, f32,
    GPT-3 XL width, the stream route; the weights are shared), launch row
    3 (fused_ffn_ln with norm "none": two launches passing hid; with norm
    "pre": three, passing xn too) and row 2 (fused_out_ln) C7_REPS times
    each without synchronising. Every output must match its own thread's
    plain version within 1e-4 + 1e-4·|ref|, and every call must have
    taken the stream route. Prints the launches, the outputs out of
    tolerance and the largest error; fails on any bad output."""
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops.fused_block import (ffn_ln_reference,
                                                  fused_ffn_ln, fused_out_ln,
                                                  out_ln_reference)
    D, I, M, tol = 2048, 8192, 8, 1e-4
    g = torch.Generator(device="cuda").manual_seed(7)

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * s

    w, b, ln_s, ln_b = rn(D, D, s=0.02), rn(D, s=0.02), \
        1.0 + rn(D, s=0.1), rn(D, s=0.1)
    w1, b1, w2, b2 = rn(D, I, s=0.02), rn(I, s=0.02), rn(I, D, s=0.01), \
        rn(D, s=0.02)
    calls = []
    for _ in range(2):
        x, a, res = rn(M, D), rn(M, D), rn(M, D)
        calls.append([
            (lambda x=x, res=res: fused_ffn_ln(x, w1, b1, w2, b2, res),
             ffn_ln_reference(x, w1, b1, w2, b2, res)),
            (lambda x=x, res=res: fused_ffn_ln(x, w1, b1, w2, b2, res, ln_s,
                                               ln_b, norm="pre"),
             ffn_ln_reference(x, w1, b1, w2, b2, res, ln_s, ln_b,
                              norm="pre")),
            (lambda a=a, res=res: fused_out_ln(a, w, b, res, ln_s, ln_b),
             out_ln_reference(a, w, b, res, ln_s, ln_b))])
    torch.cuda.synchronize()
    outs = [[], []]
    errors = []
    go = threading.Barrier(2)

    def run(k):
        try:
            go.wait(60)
            for _ in range(C7_REPS):
                for j, (fn, _ref) in enumerate(calls[k]):
                    outs[k].append((j, fn()))
        except Exception as e:          # reported below, then failed
            errors.append(f"{type(e).__name__}: {e}")

    before = launch_counts()
    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = launch_counts()
    launches = {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)}
    bad, worst = 0, 0.0
    for k in range(2):
        for j, got in outs[k]:
            ref = calls[k][j][1]
            pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
            for g_, r_ in pairs:
                err = float((g_ - r_).abs().max())
                worst = max(worst, err)
                bad += not within(g_, r_, tol, tol)
    print(json.dumps({"check": "c7_two_threads", "reps": C7_REPS,
                      "calls": [len(o) for o in outs], "launches": launches,
                      "bad_outputs": bad, "max_abs_err": worst, "tol": tol,
                      "wall_s": round(wall, 3), "errors": errors[:4]}),
          flush=True)
    want = 2 * C7_REPS
    if errors or any(t.is_alive() for t in threads) or bad \
            or launches.get("fused_ffn_ln.stream") != 2 * want \
            or launches.get("fused_out_ln.stream") != want:
        fail(f"C7: two threads on one stream: {bad} outputs off their plain "
             f"versions (max abs err {worst}), launches {launches}, "
             f"errors {errors[:4]}")


def read_parts_phase(torch):
    """--read-parts: where one read of the GPT-3 XL checkpoint (seed-0
    weights, 5.26 GB in 1 MiB chunks, written just before: the page
    cache is warm) goes. The former serial read timed part by part: the
    chunk files read one by one (files_s), each re-hashed with sha256
    (sha256_s), each array's chunks joined and copied out of the buffer
    (join_copy_s), and the whole of it as the store did it
    (serial_restore_s); then CheckpointStore.restore as it reads now
    (restore_s: every chunk read and verified on a thread pool straight
    into its array), the cast and upload of the restored arrays
    (GPTDecodeModel's _prepare: upload_s) and read_checkpoint end to end
    (read_checkpoint_s). Every restore is held bit-equal to the weights
    saved."""
    import hashlib
    import shutil
    import tempfile
    import numpy as np
    from paddle_tpu_torch.checkpoint import CheckpointStore
    from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    from paddle_tpu_torch.serving import GPTDecodeModel
    from paddle_tpu_torch.serving.model import _prepare, _tree_items
    cfg = GPTConfig.gpt3_1p3b()
    model = GPTDecodeModel(cfg, params=init_gpt_params(cfg, seed=0))
    root = tempfile.mkdtemp(prefix="chip_smoke_read_")
    try:
        t = time.perf_counter()
        model.save_checkpoint(root)
        save_s = time.perf_counter() - t
        store = CheckpointStore(root)
        ents = store.latest_manifest()["arrays"]
        nbytes = sum(int(e["nbytes"]) for e in ents.values())
        row = {"phase": "checkpoint_read_parts", "bytes": nbytes,
               "chunks": sum(len(e["chunks"]) for e in ents.values()),
               "page_cache": "warm", "save_s": round(save_s, 3)}
        t = time.perf_counter()
        blobs = {name: [open(store.chunks._path(c["h"]), "rb").read()
                        for c in ent["chunks"]]
                 for name, ent in ents.items()}
        row["files_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for name, ent in ents.items():
            for c, data in zip(ent["chunks"], blobs[name]):
                if hashlib.sha256(data).hexdigest() != c["h"]:
                    fail(f"read parts: chunk {c['h']} corrupt")
        row["sha256_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for name, ent in ents.items():
            np.frombuffer(b"".join(blobs[name]), np.dtype(ent["dtype"])) \
                .reshape(tuple(ent["shape"])).copy()
        row["join_copy_s"] = time.perf_counter() - t
        del blobs
        t = time.perf_counter()
        serial = {}
        for name, ent in ents.items():
            parts = [store.chunks.get(c["h"]) for c in ent["chunks"]]
            serial[name] = np.frombuffer(b"".join(parts), np.dtype(
                ent["dtype"])).reshape(tuple(ent["shape"])).copy()
        row["serial_restore_s"] = time.perf_counter() - t
        t = time.perf_counter()
        arrays, _ = store.restore()
        row["restore_s"] = time.perf_counter() - t
        if any(arrays[k].tobytes() != serial[k].tobytes() for k in ents):
            fail("read parts: the threaded restore differs from the serial "
                 "read")
        del serial
        template = []
        for path, leaf in _tree_items(model.params):
            if isinstance(leaf, list):
                template.append((path, leaf[0].dtype,
                                 (len(leaf),) + tuple(leaf[0].shape)))
            else:
                template.append((path, leaf.dtype, tuple(leaf.shape)))
        t = time.perf_counter()
        _prepare(arrays, template, root, model.device)
        row["upload_s"] = time.perf_counter() - t
        del arrays
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        prepared = model.read_checkpoint(root)
        row["read_checkpoint_s"] = time.perf_counter() - t
        same = all(torch.equal(p, q) for (_a, p), (_b, q) in zip(
            _leaves(prepared), _leaves(model.params)))
        if not same:
            fail("read parts: read_checkpoint differs from the weights saved")
        for k in [k for k in row if k.endswith("_s")]:
            sec, row[k] = row[k], round(row[k], 3)
            row[k[:-2] + "_gb_per_s"] = round(nbytes / sec / 1e9, 3)
        print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _leaves(params):
    """(path, tensor) of a decode model's parameters, blocks layer by
    layer."""
    out = [((k,), params[k]) for k in sorted(params) if k != "blocks"]
    for i, blk in enumerate(params["blocks"]):
        out += [(("blocks", i, k), blk[k]) for k in sorted(blk)]
    return out


def serving_wide_heads_phase(torch):
    """Decode at a head width past the vector paged kernel, on the card:
    a 2-layer GPT with heads of 256 (hidden 512, 2 heads; the reference
    serves it through paged_attention_xla, the vector kernel takes
    head_dim <= 128) served through Engine from seeded weights: five
    greedy requests, one sharing a 2-page prefix with another so that
    prefill_tail runs too. Every request must end "done", every
    paged-attention launch must take the scalar kernel, and each
    request's tokens must equal those of the same weights served by the
    plain versions (composed blocks, attn_impl="plain"). Returns the
    run's launch counts."""
    import numpy as np
    from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.serving import Engine, GPTDecodeModel
    cfg = GPTConfig(vocab_size=8192, hidden_size=512, num_layers=2,
                    num_heads=2, max_position_embeddings=512)
    model = GPTDecodeModel(cfg, params=init_gpt_params(cfg, seed=2))
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, (n,))
               for n in (64, 16, 31, 100, 64)]
    prompts[4][:32] = prompts[0][:32]
    news = [16, 24, 12, 20, 16]

    def serve(m, **kw):
        eng = Engine(m, num_slots=4, num_pages=64, page_size=16, **kw)
        first = eng.submit(prompts[0], news[0])
        eng.step()             # prefill request 0 so its pages are cached
        reqs = [first] + [eng.submit(p, n)
                          for p, n in zip(prompts[1:], news[1:])]
        eng.run_until_idle()
        torch.cuda.synchronize()
        return eng, reqs

    reset_launch_counts()
    t0 = time.perf_counter()
    eng, reqs = serve(model, prefix_cache_pages=16)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    bad = [(r.id, r.status, r.error) for r in reqs if r.status != "done"]
    if bad:
        fail(f"d=256 serving: requests not done: {bad}")
    plain_model = GPTDecodeModel(dataclasses.replace(cfg,
                                                     fused_blocks=False),
                                 params=model.params, attn_impl="plain")
    _, plain = serve(plain_model)
    got = [r.result().tolist() for r in reqs]
    want = [r.result().tolist() for r in plain]
    st = eng.stats()
    print(json.dumps({"phase": "serving_wide_heads",
                      "config": "hidden=512 heads=2 head_dim=256 layers=2 "
                                "f32 pools, pages of 16",
                      "requests": len(reqs), "wall_s": round(wall, 3),
                      "prefix_cache": st["prefix_cache"],
                      "compiles": st["compiles"], "launches": counts,
                      "tokens_equal_plain": got == want}), flush=True)
    if counts.get("paged_attention", 0) <= 0 \
            or counts.get("paged_attention.scalar", 0) \
            != counts["paged_attention"]:
        fail(f"d=256 serving: paged attention must take the scalar kernel "
             f"only: {counts}")
    if not any(k.startswith("prefill_tail") for k in st["compiles"]):
        fail(f"d=256 serving: no prefill_tail call: {st['compiles']}")
    if got != want:
        fail(f"d=256 serving: greedy tokens differ from the plain "
             f"versions': {got} vs {want}")
    return counts


def prefill_kind(rows):
    """The key of a prefill call of `rows` rows in sub_block_routes:
    at most _STREAM_MAX_ROWS (the stream route's), fewer than
    _FFMA_MIN_ROWS (SIMT's), or at least that (FFMA's)."""
    from paddle_tpu_torch.ops.fused_block import (_FFMA_MIN_ROWS,
                                                  _STREAM_MAX_ROWS)
    if rows >= _FFMA_MIN_ROWS:
        return f"prefill_ge_{_FFMA_MIN_ROWS}"
    if rows <= _STREAM_MAX_ROWS:
        return f"prefill_le_{_STREAM_MAX_ROWS}"
    return f"prefill_lt_{_FFMA_MIN_ROWS}"


_THREAD_LAUNCHES = threading.local()


def count_launches_by_thread():
    """Makes every kernel wrapper's launch also count in the tally of the
    thread that launched it (``_THREAD_LAUNCHES.counts``, while a tap
    has set one): two engines in one process decode on their own threads
    at once, and the process-wide counts cannot tell their launches
    apart. Patches paddle_tpu_torch.ops._build.note_launch once (every
    wrapper calls it through the module); the process-wide counts go on
    as before."""
    from paddle_tpu_torch.ops import _build
    if getattr(_build.note_launch, "by_thread", False):
        return
    note = _build.note_launch

    def note_launch(name):
        note(name)
        counts = getattr(_THREAD_LAUNCHES, "counts", None)
        if counts is not None:
            counts[name] = counts.get(name, 0) + 1

    note_launch.by_thread = True
    _build.note_launch = note_launch


def tap_sub_block_routes(model, prefixes=("fused_out_ln.", "fused_ffn_ln.")):
    """Wraps the model's prefill, prefill_tail and decode (instance
    attributes over the class's) to add up, for each kind of call
    ("decode", and prefill by prefill_kind), the launches the calling
    thread made in it of the counters named by `prefixes` (by default
    the sub-blocks' routes). Returns that (live) dict."""
    count_launches_by_thread()
    by_call = {}

    def tap(fn, kind):
        def run(params, cache, tokens, *rest):
            outer = getattr(_THREAD_LAUNCHES, "counts", None)
            _THREAD_LAUNCHES.counts = mine = {}
            try:
                out = fn(params, cache, tokens, *rest)
            finally:
                _THREAD_LAUNCHES.counts = outer
            key = kind if kind == "decode" \
                else prefill_kind(tokens.shape[0])
            ent = by_call.setdefault(key, {})
            for k, v in mine.items():
                if k.startswith(prefixes):
                    ent[k] = ent.get(k, 0) + v
            return out
        return run

    for name, kind in (("prefill", "prefill"), ("prefill_tail", "prefill"),
                       ("decode", "decode")):
        setattr(model, name, tap(getattr(model, name), kind))
    return by_call


def check_serving_routes(by_call):
    """Every decode launch of the sub-blocks on the stream route, every
    prefill launch on its rows' route (stream up to _STREAM_MAX_ROWS,
    SIMT below _FFMA_MIN_ROWS, FFMA from there), and at least one
    decode, one prefill below _FFMA_MIN_ROWS and one at or above."""
    from paddle_tpu_torch.ops.fused_block import (_FFMA_MIN_ROWS,
                                                  _STREAM_MAX_ROWS)
    short = (f"prefill_le_{_STREAM_MAX_ROWS}", f"prefill_lt_{_FFMA_MIN_ROWS}")
    if not any(by_call.get(k) for k in short):
        fail(f"serving path: no prefill below {_FFMA_MIN_ROWS} rows "
             f"({by_call})")
    for key, route, needed in (
            ("decode", "stream", True),
            (f"prefill_ge_{_FFMA_MIN_ROWS}", "ffma", True),
            (short[0], "stream", False), (short[1], "simt", False)):
        got = by_call.get(key, {})
        bad = {k: v for k, v in got.items() if not k.endswith(f".{route}")}
        if bad or (needed and not got):
            fail(f"serving path: {key} launches {got}, all expected on the "
                 f"{route} route")


def profile_steps(torch, run, steps, what, top_n=12):
    """Device time by kernel over `steps` calls of run(): each kernel's
    ms and launches per step, and the device's busy share of the wall
    time; beside them, the device time of each of the port's own kernels
    (port_kernels, however far down the list) and the port's launch
    counters over the same calls (a kernel the profiler lists fewer times
    than its wrapper counted is missing from the busy time). One more
    call runs first under the profiler's warm-up, traced and dropped: a
    trace that starts cold loses its first kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from paddle_tpu_torch.observability import TRACER
    from paddle_tpu_torch.ops import launch_counts
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        before = launch_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = {k: (v - before.get(k, 0)) / steps
               for k, v in launch_counts().items() if v != before.get(k, 0)}
    spans = {sp.name for sp in TRACER.spans()}
    by_name: dict[str, list] = {}
    for e in prof.events():
        # device work only: kernels, copies and sets, not the host spans
        # that record_function mirrors onto the device timeline
        if e.device_type != DeviceType.CUDA or e.name in spans \
                or getattr(e, "is_user_annotation", False):
            continue
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ").split("(")[0]
        ent = by_name.setdefault(name[:60], [0.0, 0])
        ent[0] += e.time_range.elapsed_us() / 1e3
        ent[1] += 1
    busy = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    port = sorted((kv for kv in by_name.items()
                   if kv[0].startswith(PORT_KERNEL_NAMES)),
                  key=lambda kv: -kv[1][0])
    print(json.dumps({
        "phase": "profile", "what": what, "steps": steps,
        "wall_ms_per_step": round(wall * 1e3 / steps, 3),
        "device_busy_ms_per_step": round(busy / steps, 3),
        "device_busy_share": round(busy / (wall * 1e3), 4),
        "top_kernels": [{"name": k, "ms_per_step": round(v[0] / steps, 4),
                         "launches_per_step": v[1] / steps}
                        for k, v in top],
        "port_kernels": [{"name": k, "ms_per_step": round(v[0] / steps, 4),
                          "launches_per_step": v[1] / steps}
                         for k, v in port],
        "port_launches_per_step": counted}), flush=True)
    return {k: (v[0] / steps, v[1] / steps) for k, v in by_name.items()}


def profile_decode(torch, eng, vocab, steps=10):
    """Device-time breakdown of `steps` full-batch decode steps (8
    slots, 64-token prompts)."""
    import numpy as np
    rng = np.random.RandomState(1)
    reqs = [eng.submit(rng.randint(0, vocab, (64,)), steps + 8)
            for _ in range(eng.num_slots)]
    for _ in range(3):                 # admit + prefill all, warm decode
        eng.step()
    profile_steps(torch, eng.step, steps, "decode")
    eng.run_until_idle()
    if any(r.status != "done" for r in reqs):
        fail("profiled requests did not finish")


def train_ids(vocab: int):
    import numpy as np
    return np.random.RandomState(0).randint(
        0, vocab, (1, TRAIN_TOKENS)).astype(np.int32)


def train_parity(torch, tree, layers=2, steps=3, rtol=2e-2):
    """The kernel train step against the composed one on GPT-3 XL cut to
    `layers` layers (full width, bf16), same weights and ids. Both run
    bf16 blocks that round at different places (the kernels keep P, the
    gelu intermediate and the LN input in f32), so the curves agree to
    bf16 precision: within `rtol` relative."""
    import math
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.parallel import HybridParallelTrainStep
    small = {k: tree[k] for k in ("wte", "wpe", "lnf_s", "lnf_b")}
    small["blocks"] = {k: v[:layers] for k, v in tree["blocks"].items()}
    curves = {}
    for name, kw in (("kernels", dict(attn_impl="flash", fused_blocks=True)),
                     ("composed", dict(attn_impl="xla",
                                       fused_blocks=False))):
        cfg = GPTConfig.gpt3_1p3b(num_layers=layers, amp_dtype="bfloat16",
                                  remat=True, **kw)
        step = HybridParallelTrainStep(cfg, grad_clip_norm=1.0,
                                       params=small)
        ids = train_ids(cfg.vocab_size)
        curves[name] = [float(step(ids)) for _ in range(steps)]
        del step
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(curves["kernels"],
                                                curves["composed"])]
    print(json.dumps({"phase": "train_parity", "layers": layers,
                      "tokens": TRAIN_TOKENS, "dtype": "bfloat16",
                      "kernels": curves["kernels"],
                      "composed": curves["composed"], "max_rel": max(rel),
                      "rtol": rtol}), flush=True)
    if not all(math.isfinite(x) for c in curves.values() for x in c) \
            or not max(rel) <= rtol:
        fail(f"kernel and composed train steps disagree: {curves}")


def training_path(torch, tree, steps=5):
    """bench.py's bench_gpt_1p3b through the port: 1 warm-up + 4 timed
    steps. Returns (launch counts of the run, the train step, ids)."""
    import math
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.observability.perf import gpt_train_flops_per_step
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.parallel import HybridParallelTrainStep
    cfg = GPTConfig.gpt3_1p3b(amp_dtype="bfloat16", attn_impl="flash",
                              remat=True)
    t0 = time.perf_counter()
    step = HybridParallelTrainStep(cfg, dp=1, pp=1, tp=1,
                                   grad_clip_norm=1.0, params=tree)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    ids = train_ids(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = launch_counts()
    step_s = statistics.median(times[1:])
    flops = gpt_train_flops_per_step(cfg, 1, TRAIN_TOKENS)
    main = {"phase": "training_path", "config": "gpt3_1p3b bf16 flash "
            "remat dp=pp=tp=1 clip=1.0", "batch": 1, "seq": TRAIN_TOKENS,
            "losses": losses, "step_ms": [round(t * 1e3, 3) for t in times],
            "step_ms_median": round(step_s * 1e3, 3),
            "tokens_per_s": round(TRAIN_TOKENS / step_s, 2),
            "mfu_bf16": round(flops / step_s / BF16_FLOPS, 5),
            "flops_per_step": flops, "upload_s": round(upload_s, 2),
            "max_memory_allocated_gb": round(
                torch.cuda.max_memory_allocated() / 1e9, 3),
            # the peak of the bytes the tensors asked for: what
            # max_memory_allocated counts less the caching allocator's
            # rounding of blocks (up to 1 MiB a large block)
            "max_memory_requested_gb": round(torch.cuda.memory_stats()[
                "requested_bytes.all.peak"] / 1e9, 6),
            "launches": counts}
    print(json.dumps(main), flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall: {losses}")
    missing = [k for k in TRAINING_KERNELS if counts.get(k, 0) <= 0]
    if missing:
        fail(f"kernels never launched on the training path: {missing} "
             f"(counts {counts})")
    # each layer runs both sub-blocks and flash forward and again in its
    # remat, and the two flash backward kernels once
    L = cfg.num_layers * steps
    off_route(counts, {"fused_out_ln": 2 * L, "fused_ffn_ln": 2 * L,
                       "flash_fwd": 2 * L, "flash_bwd_dq": L,
                       "flash_bwd_dkv": L}, "GPT training path")
    gpt_dropout_step(torch, tree, ids, counts, steps)
    return counts, step, ids


def gpt_dropout_step(torch, tree, ids, counts, steps):
    """One step of the same GPT-3 XL train step at dropout 0.1 (residual
    dropout in the sub-blocks' epilogues, the embedding's in tensor
    code): the loss finite, and the launches of rows 2-5 (and their
    routes) those of one dropout-0 step."""
    import math
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.parallel import HybridParallelTrainStep
    cfg = GPTConfig.gpt3_1p3b(amp_dtype="bfloat16", attn_impl="flash",
                              remat=True, dropout=0.1)
    step = HybridParallelTrainStep(cfg, dp=1, pp=1, tp=1,
                                   grad_clip_norm=1.0, params=tree)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    loss = float(step(ids))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launch_counts()
    want = {k: v // steps for k, v in counts.items()}
    print(json.dumps({"phase": "gpt_dropout_step", "dropout": 0.1,
                      "loss": loss, "step_ms": round(wall * 1e3, 3),
                      "launches": got, "launches_p0_step": want}),
          flush=True)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    if not math.isfinite(loss):
        fail(f"GPT at dropout 0.1: non-finite loss {loss}")
    if got != want:
        fail(f"GPT at dropout 0.1: launches {got} against a dropout-0 "
             f"step's {want}")


def off_route(counts, want, what, route="tc"):
    """Fails unless each kernel in `want` launched exactly that often, all
    of them on `route` (one of the kernel's routes in design_of)."""
    off = {k: (counts.get(k, 0), counts.get(f"{k}.{route}", 0), n)
           for k, n in want.items()
           if not counts.get(k, 0) == counts.get(f"{k}.{route}", 0) == n}
    if off:
        fail(f"{what}: launches (all, on the {route} route, expected) off "
             f"the {route} route: {off}")


def bert_batch(vocab: int):
    """bench.py's bench_bert batch: ids, masked positions, MLM labels and
    NSP labels from np.random.RandomState(0)."""
    import numpy as np
    rng = np.random.RandomState(0)
    ids = rng.randint(4, vocab, (BERT_BATCH, BERT_SEQ)).astype("int64")
    pos = np.stack([np.sort(rng.choice(BERT_SEQ, BERT_PRED, replace=False))
                    for _ in range(BERT_BATCH)]).astype("int64")
    mlm = np.take_along_axis(ids, pos, axis=1)
    nsp = rng.randint(0, 2, (BERT_BATCH, 1)).astype("int64")
    return ids, pos, mlm, nsp


def bert_loss_fn(m, ids, pos, mlm, nsp):
    logits, nsp_logits = m(ids, masked_positions=pos)
    return m.loss(logits, nsp_logits, mlm, nsp)


def bert_model(layers: int, seed: int = 0, dropout: float | None = None):
    """BERT-base cut to `layers` layers from the port's seeded
    initialisers; `dropout` (hidden and attention) other than the
    config's 0.1 when given."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.nn import initializer
    initializer.seed(seed)
    kw = {} if dropout is None else dict(
        hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
    cfg = BertConfig.base(num_hidden_layers=layers, **kw)
    model = BertForPretraining(cfg)
    model.train()
    return cfg, model


def bert_parity(torch, layers=2, steps=3, rtol=2e-2):
    """The BERT train step through the kernels against the same step
    through the composed chains (the plain versions under autograd) on
    the card: BERT-base cut to `layers` layers at full width, dropout
    0.1, AMP O1, the same weights, batch and step seeds, so both sides
    drop the same elements. The sub-block ops run in f32 on both sides
    and attention in bf16, where the kernels round the unnormalised P
    blockwise as the reference does and the composed chain rounds the
    softmax: the curves agree to bf16 precision, within `rtol`
    relative."""
    import math
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import functional as F
    curves = {}
    for name in ("kernels", "composed"):
        cfg, model = bert_model(layers)
        step = make_train_step(model, bert_loss_fn, optimizer="adamw",
                               lr=1e-4, amp_level="O1")
        batch = bert_batch(cfg.vocab_size)
        with F.composed_ops(name == "composed"):
            curves[name] = [float(step(*batch, seed=100 + i))
                            for i in range(steps)]
        del step, model
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(curves["kernels"],
                                                curves["composed"])]
    print(json.dumps({"phase": "bert_parity", "layers": layers,
                      "batch": BERT_BATCH, "seq": BERT_SEQ, "amp": "O1",
                      "dropout": 0.1, "kernels": curves["kernels"],
                      "composed": curves["composed"], "max_rel": max(rel),
                      "rtol": rtol}), flush=True)
    if not all(math.isfinite(x) for c in curves.values() for x in c) \
            or not max(rel) <= rtol:
        fail(f"kernel and composed BERT train steps disagree: {curves}")


def bert_training_path(torch, steps=5):
    """bench.py's bench_bert through the port: 1 warm-up + 4 timed
    steps. Returns (launch counts of the run, the train step, batch).

    The loss is the sum of the masked-LM term (304 predictions over a
    30522-word vocabulary, ln V = 10.3 at the start) and the
    next-sentence term (16 two-way labels). At lr 1e-4 without warm-up
    Adam's first steps move every weight by 1e-4 in the gradient's sign,
    which overshoots on the 16 next-sentence labels: that term swings
    between 0.2 and 4 nats from step to step (seen at 2 layers on the
    CPU too, in f32), while the masked-LM term falls steadily. So the
    sum must be finite at every step, and the check that the model
    learns is on the masked-LM term: the fifth step's below the
    first's."""
    import math
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.observability.perf import bert_train_flops_per_step
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    t0 = time.perf_counter()
    cfg, model = bert_model(BERT_LAYERS)
    init_s = time.perf_counter() - t0
    nsp_terms = []

    def loss_fn(m, ids, pos, mlm, nsp):
        logits, nsp_logits = m(ids, masked_positions=pos)
        with torch.no_grad():       # the sum's second term, for the record
            nsp_terms.append(F.cross_entropy(nsp_logits, nsp))
        return m.loss(logits, nsp_logits, mlm, nsp)

    step = make_train_step(model, loss_fn, optimizer="adamw", lr=1e-4,
                           amp_level="O1")
    batch = tuple(torch.as_tensor(a, device="cuda")
                  for a in bert_batch(cfg.vocab_size))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = launch_counts()
    nsp_losses = [float(t) for t in nsp_terms]
    mlm_losses = [a - b for a, b in zip(losses, nsp_losses)]
    step_s = statistics.median(times[1:])
    flops = bert_train_flops_per_step(cfg, BERT_BATCH, BERT_SEQ, BERT_PRED)
    main = {"phase": "bert_training_path", "config": "bert_base O1 adamw "
            "lr=1e-4 dropout=0.1", "batch": BERT_BATCH, "seq": BERT_SEQ,
            "n_pred": BERT_PRED, "losses": losses,
            "mlm_losses": mlm_losses, "nsp_losses": nsp_losses,
            "step_ms": [round(t * 1e3, 3) for t in times],
            "step_ms_median": round(step_s * 1e3, 3),
            "samples_per_s": round(BERT_BATCH / step_s, 2),
            "tokens_per_s": round(BERT_BATCH * BERT_SEQ / step_s, 2),
            "mfu_bf16": round(flops / step_s / BF16_FLOPS, 5),
            "flops_per_step": flops, "init_s": round(init_s, 2),
            "max_memory_allocated_gb": round(
                torch.cuda.max_memory_allocated() / 1e9, 3),
            # the peak of the bytes the tensors asked for: what
            # max_memory_allocated counts less the caching allocator's
            # rounding of blocks (up to 1 MiB a large block)
            "max_memory_requested_gb": round(torch.cuda.memory_stats()[
                "requested_bytes.all.peak"] / 1e9, 6),
            "launches": counts,
            "launches_predicted": {k: v * steps for k, v in
                                   BERT_LAUNCHES_PER_STEP.items()}}
    print(json.dumps(main), flush=True)
    MEASURED["bert_samples_per_s"] = main["samples_per_s"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite BERT training loss: {losses}")
    if not mlm_losses[-1] < mlm_losses[0]:
        fail(f"BERT masked-LM loss did not fall: {mlm_losses} (sums "
             f"{losses})")
    wrong = {k: (counts.get(k, 0), v * steps)
             for k, v in BERT_LAUNCHES_PER_STEP.items()
             if counts.get(k, 0) != v * steps}
    if wrong:
        fail(f"BERT path launches (got, predicted): {wrong}")
    # attention runs in bf16 under O1: every flash launch on the tensor
    # cores; the sub-blocks stay f32 at M = 2048 tokens: every launch on
    # the FFMA route
    off_route(counts, {k: BERT_LAUNCHES_PER_STEP[k] * steps for k in
                       ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
              "BERT training path")
    off_route(counts, {k: BERT_LAUNCHES_PER_STEP[k] * steps for k in
                       ("fused_out_ln", "fused_ffn_ln")},
              "BERT training path", "ffma")
    # layer norm (f32 under O1, C = 768, R = 2048 and 304): the warp route
    off_route(counts, {k: BERT_LAUNCHES_PER_STEP[k] * steps for k in
                       ("layer_norm_fwd", "layer_norm_bwd_dx")},
              "BERT training path", "warp")
    return counts, step, batch


def encoder_layer_phase(torch):
    """One TransformerEncoderLayer(768, 12, 3072) with the constructor's
    defaults (relu, act_dropout = dropout = 0.1, post-LN) in training
    mode, forward and backward at (16, 128, 768) in f32: the activation
    dropout keeps the FFN off the one-kernel block, so its epilogue is
    the dropout + residual + layer norm kernel pair, both on the warp
    route (ENCODER_LAYER_LAUNCHES: any other count fails). Kernels
    against the composed chains under the same step seed: output and
    every gradient within 1e-3 + 1e-3 |ref| (f32 GEMMs of 768 and 3072
    terms in other orders through the layer). Returns the run's launch
    counts."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import initializer
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    initializer.seed(1)
    layer = nn.TransformerEncoderLayer(768, 12, 3072).to("cuda")
    layer.train()
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(BERT_BATCH, BERT_SEQ, 768, generator=g, device="cuda")
    dy = torch.randn(BERT_BATCH, BERT_SEQ, 768, generator=g, device="cuda")
    params = list(layer.parameters())

    def run():
        xr = x.clone().requires_grad_()
        with F.seed_scope(11):
            y = layer(xr)
        return [y.detach(), *torch.autograd.grad(y, [xr, *params], dy)]

    reset_launch_counts()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    with F.composed_ops():
        want = run()
    torch.cuda.synchronize()
    tol = {"atol": 1e-3, "rtol": 1e-3}
    names = ["y", "dx"] + [n for n, _ in layer.named_parameters()]
    errs = {n: max_err(a, b) for n, a, b in zip(names, got, want)}
    bad = [n for n, a, b in zip(names, got, want) if not within(a, b, **tol)]
    print(json.dumps({"phase": "encoder_layer", "config": "d_model=768 "
                      "nhead=12 ffn=3072 relu dropout=act_dropout=0.1 "
                      "post-LN f32", "shape": [BERT_BATCH, BERT_SEQ, 768],
                      "first_call_ms": round(wall * 1e3, 3),
                      "max_abs_err": max(errs.values()), "tol": tol,
                      "launches": counts}), flush=True)
    if bad:
        fail(f"encoder layer: kernels and composed chains disagree on "
             f"{bad}: {errs}")
    wrong = {k: (counts.get(k, 0), v)
             for k, v in ENCODER_LAYER_LAUNCHES.items()
             if counts.get(k, 0) != v}
    if wrong:
        fail(f"encoder layer launches (got, predicted): {wrong}")
    return counts


def check_ffn(torch, timer, results):
    """B row 10, ``ops.fused_ffn``, against its plain version: the
    bert_base_512 preset (M = 8192, H = 768, I = 3072), BERT-base's
    16 x 128 tokens (M = 2048) and GPT-3 XL width in bf16 (M = 1024,
    H = 2048, I = 8192), gelu and relu; and the preset once more in f32
    and in bf16 with x (and every copy the timing makes) 8 bytes off a
    16-byte boundary, gelu, which only the SIMT kernel takes. Each row
    names the route it took and fails on another (f32 at these shapes
    on ``ffma``, bf16 on ``tc``, misaligned on ``simt``), checks a
    bit-identical rerun, and gives device time a call (tc_times: the
    kernel, the plain version and the library chain) beside one call by
    events (call_ms); the f32 preset also the time on every pair of FFMA
    tiles (tile_ms). Tolerance: f32 sums of 768
    and 3072 terms in other orders, |err| <= 1e-4 + 1e-4 |ref|; bf16
    rounds hid and y once each in both (2**-8 relative), 2e-2 + 2e-2
    |ref|. The library yardstick is addmm, the activation, addmm
    (cuBLAS, TF32 off for f32)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.fused_ffn import ffn_reference, fused_ffn
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(FFN_M, FFN_H, FFN_I, f32, False),
             (FFN_M, FFN_H, FFN_I, bf16, False),
             (2048, 768, 3072, f32, False), (2048, 768, 3072, bf16, False),
             (1024, 2048, 8192, bf16, False),
             (FFN_M, FFN_H, FFN_I, f32, True),
             (FFN_M, FFN_H, FFN_I, bf16, True)]
    g = torch.Generator(device="cuda").manual_seed(4)
    for M, H, I, dt, off in cases:
        def rn(*shape, sc=1.0):
            return (torch.randn(*shape, generator=g, device="cuda")
                    * sc).to(dt)
        x, w1, b1 = rn(M, H), rn(H, I, sc=0.02), rn(I, sc=0.02)
        w2, b2 = rn(I, H, sc=0.02), rn(H, sc=0.02)
        if off:
            x = misaligned(x)
        isz = 4 if dt == torch.float32 else 2
        tol = {"atol": 1e-4, "rtol": 1e-4} if dt == torch.float32 \
            else {"atol": 2e-2, "rtol": 2e-2}
        nbytes = isz * (M * H + H * I + I + I * H + H + M * H)
        bms, by = bound(nbytes, 4 * M * H * I + 10 * M * I,
                        F32_FLOPS if dt == torch.float32 else BF16_FLOPS)
        name = "f32" if dt == torch.float32 else "bf16"
        want = "simt" if off else "ffma" if dt == torch.float32 else "tc"
        for act in ("gelu",) if off else ("gelu", "relu"):
            y, route = routed("fused_ffn", lambda: fused_ffn(
                x, w1, b1, w2, b2, act), want)
            ref = ffn_reference(x, w1, b1, w2, b2, act)
            again = fused_ffn(x, w1, b1, w2, b2, act)
            torch.cuda.synchronize()
            if not torch.equal(y, again):
                fail(f"fused_ffn M={M} {name} {act}: two runs differ")

            def lib(x, w1, b1, w2, b2, act):
                u = torch.addmm(b1, x, w1)
                u = F.gelu(u) if act == "gelu" else torch.relu(u)
                return torch.addmm(b2, u, w2)

            row = {"kernel": "fused_ffn",
                   "shape": f"M={M} H={H} I={I} "
                            f"{'misaligned x ' if off else ''}{name} {act}",
                   "route": route, "max_abs_err": max_err(y, ref),
                   "tol": tol, "bit_identical_rerun": True,
                   **tc_times(torch, timer, (x, w1, b1, w2, b2, act),
                              fused_ffn, ffn_reference, lib,
                              clone=misaligned if off else None),
                   "bound_ms": bms, "bound_by": by}
            if route == "ffma" and M == FFN_M and act == "gelu":
                row["tile_ms"] = ffma_tile_ms(torch, timer, "fused_ffn", (
                    x, w1, b1, w2, b2, act))
            report(results, row, within(y, ref, **tol))


def _lenet_batch(rng, protos, batch):
    """Class-separable digits, as tests/test_mnist_lenet.py makes them."""
    lab = rng.randint(0, 10, batch).astype("int64")
    img = protos[lab] + 0.3 * rng.randn(batch, 1, 28, 28).astype("float32")
    return {"img": img, "label": lab[:, None]}


def static_lenet_phase(torch, with_profile=False):
    """bench.py's bench_lenet through the port's static graph: the
    LeNet program of ``models.lenet.build_lenet_program`` with Adam 1e-3
    minimised, startup, one warm step and LENET_STEPS timed steps of
    batch 256 on ``Executor(CUDAPlace(0))``, fresh class-separable
    digits each step (host arrays fed as a user feeds them). The loss
    must fall and the accuracy rise; prints examples/s and the
    executor's counters."""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fluid import (CUDAPlace, Executor, Scope,
                                        framework, optimizer, scope_guard,
                                        unique_name)
    from paddle_tpu_torch.models.lenet import build_lenet_program
    pt.enable_static()
    try:
        with unique_name.guard():
            main, startup, feeds, fetches = build_lenet_program()
            with framework.program_guard(main, startup):
                optimizer.Adam(learning_rate=1e-3).minimize(fetches["loss"])
    finally:
        pt.disable_static()
    rng = np.random.RandomState(0)
    protos = rng.randn(10, 1, 28, 28).astype("float32")
    batches = [_lenet_batch(rng, protos, LENET_BATCH)
               for _ in range(LENET_STEPS + 1)]
    fetch = [fetches["loss"], fetches["acc"]]
    with scope_guard(Scope()):
        exe = Executor(CUDAPlace(0))
        exe.run(startup)
        lv, av = exe.run(main, feed=batches[0], fetch_list=fetch)
        losses, accs = [float(lv[0])], [float(av[0])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [exe.run(main, feed=b, fetch_list=fetch, return_numpy=False)
                for b in batches[1:]]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if with_profile:
            profile_static(torch, exe, main, fetch, batches[0],
                           "static_lenet_step")
    losses += [float(o[0]) for o in outs]
    accs += [float(o[1]) for o in outs]
    main_d = {"phase": "static_lenet", "config": f"bench_lenet: batch {LENET_BATCH}, "
              "Adam 1e-3, separable digits", "ops_per_step":
              len(main.global_block().ops), "steps": LENET_STEPS,
              "step_ms": round(dt / LENET_STEPS * 1e3, 3),
              "examples_per_s": round(LENET_BATCH * LENET_STEPS / dt, 2),
              "losses": losses[::5] + [losses[-1]],
              "accs": accs[::5] + [accs[-1]], "executor": exe.stats()}
    print(json.dumps(main_d), flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.5 * losses[0]:
        fail(f"static LeNet loss did not fall: {losses}")
    if not accs[-1] > accs[0]:
        fail(f"static LeNet accuracy did not rise: {accs}")


def build_ffn_program(H, I, act="gelu"):
    """The static FFN program: x, t data; W1, B1, W2, B2 parameters;
    y = run_op("fused_ffn"); loss = mean((y - t) * (y - t)); Adam 1e-3
    minimised. Returns (main, startup, loss)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.common_ops import run_op
    from paddle_tpu_torch.fluid import (framework, layers, optimizer,
                                        unique_name)
    pt.enable_static()
    try:
        with unique_name.guard():
            main, startup = framework.Program(), framework.Program()
            with framework.program_guard(main, startup):
                x = layers.data("x", [-1, H], "float32")
                t = layers.data("t", [-1, H], "float32")
                w1 = layers.create_parameter([H, I], "float32")
                b1 = layers.create_parameter([I], "float32", is_bias=True)
                w2 = layers.create_parameter([I, H], "float32")
                b2 = layers.create_parameter([H], "float32", is_bias=True)
                y = run_op("fused_ffn", {"X": x, "W1": w1, "B1": b1,
                                         "W2": w2, "B2": b2},
                           {"activation": act})
                d = y - t
                loss = layers.mean(d * d)
                optimizer.Adam(learning_rate=1e-3).minimize(loss)
    finally:
        pt.disable_static()
    return main, startup, loss


def static_ffn_phase(torch, with_profile=False):
    """The static FFN program at the preset shape (M = 8192, H = 768,
    I = 3072, gelu, f32) on the card: startup, then 1 + 4 Adam steps on
    one batch whose target is a fixed map of x (t = tanh(x A), A from a
    seed). The loss must fall; fused_ffn must launch FFN_LAUNCHES_PER_STEP
    times a step, every launch on the FFMA route; the peak of allocated
    device memory over the steps is printed; the same steps from the same start under
    ``composed_ops()`` (the op's composed fallback, exact gelu) must give
    losses within 1e-3 relative; and one eager ``run_op("fused_ffn")``
    must launch the kernel once and agree with the plain version.
    Returns the kernel run's launch counts."""
    from paddle_tpu_torch import common_ops
    from paddle_tpu_torch.fluid import CUDAPlace, Executor, Scope, scope_guard
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.ops.fused_ffn import ffn_reference
    main, startup, loss = build_ffn_program(FFN_H, FFN_I)
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(FFN_M, FFN_H, generator=g, device="cuda")
    A = torch.randn(FFN_H, FFN_H, generator=g, device="cuda") / FFN_H ** 0.5
    feed = {"x": x, "t": torch.tanh(x @ A)}
    scope = Scope()
    with scope_guard(scope):
        exe = Executor(CUDAPlace(0))
        exe.run(startup)
    start = {n: scope.find_var(n).clone() for n in scope.local_var_names()}

    def train():
        sc = Scope()
        for n, v in start.items():
            sc.set(n, v.clone())
        out, times = [], []
        with scope_guard(sc):
            for _ in range(FFN_STEPS):
                t0 = time.perf_counter()
                lv = exe.run(main, feed=feed, fetch_list=[loss],
                             return_numpy=False)[0]
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                out.append(float(lv[0]))
        return out, times, sc

    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times, sc = train()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with F.composed_ops():
        reset_launch_counts()
        composed, ctimes, _ = train()
        composed_counts = launch_counts()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, composed))
    reset_launch_counts()
    w = {n: sc.find_var(n) for n in ("create_parameter_0.w_0",
                                     "create_parameter_1.b_0",
                                     "create_parameter_2.w_0",
                                     "create_parameter_3.b_0")}
    ws = list(w.values())
    y = common_ops.run_op("fused_ffn", {"X": x, "W1": ws[0], "B1": ws[1],
                                        "W2": ws[2], "B2": ws[3]},
                          {"activation": "gelu"})
    yr = ffn_reference(x, *ws, "gelu")
    torch.cuda.synchronize()
    eager = launch_counts().get("fused_ffn", 0)
    eager_err = max_err(y, yr)
    step_s = statistics.median(times[1:])
    flops = 3 * 4 * FFN_M * FFN_H * FFN_I
    print(json.dumps({
        "phase": "static_ffn", "config": f"M={FFN_M} H={FFN_H} I={FFN_I} "
        "gelu f32, Adam 1e-3, loss mean((y - t)^2)",
        "ops": [op.type for op in main.global_block().ops],
        "losses": losses, "composed_losses": composed, "max_rel": rel,
        "step_ms": [round(t * 1e3, 3) for t in times],
        "step_ms_median": round(step_s * 1e3, 3),
        "composed_step_ms_median": round(statistics.median(ctimes[1:])
                                         * 1e3, 3),
        "tokens_per_s": round(FFN_M / step_s, 2),
        "tflops_per_s_model": round(flops / step_s / 1e12, 3),
        "peak_memory_gb": round(peak_gb, 3),
        "launches": counts, "launches_predicted": {
            "fused_ffn": FFN_LAUNCHES_PER_STEP * FFN_STEPS,
            "fused_ffn.ffma": FFN_LAUNCHES_PER_STEP * FFN_STEPS},
        "composed_launches": composed_counts,
        "eager_run_op": {"launches": eager, "max_abs_err": eager_err},
        "executor": exe.stats()}), flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        fail(f"static FFN loss did not fall: {losses}")
    for name in ("fused_ffn", "fused_ffn.ffma"):
        if counts.get(name, 0) != FFN_LAUNCHES_PER_STEP * FFN_STEPS:
            fail(f"static FFN: {name} launched {counts.get(name, 0)} times, "
                 f"predicted {FFN_LAUNCHES_PER_STEP * FFN_STEPS} (launches "
                 f"by route {route_counts(counts, 'fused_ffn')})")
    if composed_counts.get("fused_ffn", 0) != 0:
        fail(f"composed_ops() still launched fused_ffn: {composed_counts}")
    if not rel <= 1e-3:
        fail(f"static FFN kernel and composed losses differ: {losses} "
             f"against {composed}")
    if eager != 1 or not within(y, yr, 1e-4, 1e-4):
        fail(f"eager run_op fused_ffn: {eager} launches, err {eager_err}")
    if with_profile:
        with scope_guard(sc):
            profile_static(torch, exe, main, [loss], feed, "static_ffn_step")
    return counts


# ---------------------------------------------------------------------------
# static_bert: the op library and the static BERT program (item 11)
# ---------------------------------------------------------------------------

# the seconds the phase is predicted to take (written before its first
# run on the card): op sweep 10, parity 12, BERT-base 15, variant 5,
# paged 3
STATIC_BERT_PREDICTED_S = 45.0
STATIC_BERT_STEPS = 10
# card against CPU: 2 layers at full width, batch 4 x 128, 3 Lamb steps
STATIC_BERT_PARITY = dict(layers=2, batch=4, steps=3, rtol=1e-3)
SWEEP_OUT_TOL = dict(atol=1e-5, rtol=1e-4)
SWEEP_GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


def static_bert_launches(layers, act_layers=0):
    """Launches of one step of the static BERT program on the card, by
    kernel and route: each fused op launches once in the forward and
    once more in its grad op, which re-runs the forward before
    autograd's backward; the flash and layer-norm backward kernels once
    a grad op. f32 throughout: the sub-blocks at M = 2048 on FFMA, flash
    on SIMT, the layer norms (embeddings, MLM head) and the act-dropout
    layers' dropout + residual + LN on the warp route."""
    ffn = layers - act_layers
    want = {"fused_out_ln.ffma": 2 * layers, "fused_ffn_ln.ffma": 2 * ffn,
            "flash_fwd.simt": 2 * layers, "flash_bwd_dq.simt": layers,
            "flash_bwd_dkv.simt": layers, "layer_norm_fwd.warp": 4,
            "layer_norm_bwd_dx.warp": 2,
            "dropout_add_ln_fwd.warp": 2 * act_layers,
            "dropout_add_ln_bwd.warp": act_layers}
    want.update({k.split(".")[0]: v for k, v in list(want.items())})
    return {k: v for k, v in want.items() if v}


def _op_cases():
    """The parity suites' op cases (tests/torch_op_cases.py, numpy only)
    by key, and the random ops' attrs and inputs."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    try:
        import torch_op_cases as C
    finally:
        sys.path.pop(0)
    cases = {**C.SWEEP, **C.MATH_OWN, **C.TENSOR_OWN, **C.NN_OWN,
             **C.OPT_CASES, **C.SEQ_OWN, **C.LOSS_OWN, **C.MISC_OWN,
             **C.TAIL_OWN}
    return cases, C.RANDOM, C.UNIQUE_PARTS


def _run_op(torch, op, inputs, attrs, device, extra=None):
    import numpy as np
    from paddle_tpu_torch.fluid import registry
    from paddle_tpu_torch.fluid.executor import ExecContext
    opdef = registry.require(op)
    a = dict(attrs)
    opdef.fill_default_attrs(a)
    a.setdefault("_rng_id", 0)
    ins = {s: [torch.as_tensor(np.array(v, copy=True), device=device)
               for v in (vals if isinstance(vals, (list, tuple))
                         else [vals])]
           for s, vals in {**inputs, **(extra or {})}.items()}
    return opdef.compute(ExecContext(0, device=device), ins, a)


def _compare(torch, got, ref, tol):
    """The slots of `ref` where `got` (on the card) is off tolerance."""
    bad = []
    for slot, vals in ref.items():
        for i, r in enumerate(vals):
            if not isinstance(r, torch.Tensor):
                continue
            g = got.get(slot, [None] * (i + 1))[i]
            if not isinstance(g, torch.Tensor) or g.shape != r.shape:
                bad.append(f"{slot}[{i}] shape")
            elif r.is_floating_point():
                gc_, rf = g.cpu().float(), r.float()
                same = (gc_ == rf) | (gc_.isnan() & rf.isnan())
                near = (gc_ - rf).abs() <= tol["atol"] + tol["rtol"] \
                    * rf.abs()
                if not bool((same | near).all()):
                    bad.append(f"{slot}[{i}] {max_err(gc_, rf):.3g}")
            elif not torch.equal(g.cpu(), r):
                bad.append(f"{slot}[{i}] values")
    return bad


# the op modules of the library's first part (11a) and of its second
# (11b)
OPS_FIRST = ("math_ops", "nn_ops", "tensor_ops", "random_ops", "metric_ops",
             "optimizer_ops")
OPS_SECOND = ("sequence_ops", "structured_loss_ops", "misc_ops", "tail_ops")


def card_op_sweep(torch, modules=OPS_FIRST, phase="static_bert_op_sweep"):
    """(a) Every op of `modules` (fluid/ops) on its CPU parity case's
    inputs, on the card against the CPU: outputs (atol 1e-5, rtol 1e-4)
    and, where it has one, its grad op's input gradients for fixed
    random upstream gradients (atol 1e-4, rtol 1e-3). The random ops are
    held to their CPU counterpart's shape and dtype (their streams
    differ by device); the decompositions by what is unique of their
    outputs (torch_op_cases.UNIQUE_PARTS, as the parity tests); nce by
    its cost on the card's own samples. Returns (ops swept, cases
    run)."""
    import numpy as np
    from paddle_tpu_torch.fluid import registry
    cases, random_ops, unique_parts = _op_cases()
    ops = sorted(k for k, d in registry._REGISTRY.items()
                 if not k.endswith("_grad") and d.compute.__module__ in {
                     f"paddle_tpu_torch.fluid.ops.{m}" for m in modules})
    failed, grads, n_cases = {}, 0, 0
    for op in ops:
        if op in random_ops:
            attrs, ins = random_ops[op]
            g = _run_op(torch, op, ins, attrs, "cuda")["Out"][0]
            r = _run_op(torch, op, ins, attrs, "cpu")["Out"][0]
            if g.shape != r.shape or g.dtype != r.dtype or (
                    op == "seed" and not torch.equal(g.cpu(), r)):
                failed[op] = ["random draw shape / dtype"]
            n_cases += 1
            continue
        if op == "nce":
            n_cases += 1
            bad = nce_on_card(torch)
            if bad:
                failed[op] = bad
            continue
        mine = [c for c in cases.values() if c.op == op]
        if not mine:
            failed[op] = ["no case"]
        for case in mine:
            n_cases += 1
            try:
                got = _run_op(torch, op, case.inputs, case.attrs, "cuda")
                ref = _run_op(torch, op, case.inputs, case.attrs, "cpu")
            except Exception as e:  # noqa: BLE001 - reported by op name
                failed.setdefault(op, []).append(f"{type(e).__name__}: {e}")
                continue
            if op in unique_parts:
                got, ref = ({k: [torch.as_tensor(np.asarray(v))]
                             for k, v in unique_parts[op](
                                 {s: [v.cpu().numpy() for v in vals]
                                  for s, vals in outs.items()}).items()}
                            for outs in (got, ref))
            bad = _compare(torch, got, ref, SWEEP_OUT_TOL)
            opdef = registry.require(op)
            if opdef.grad is not None and not case.skip_grad:
                rng = np.random.RandomState(7)
                og = {f"{s}@GRAD": [np.asarray(rng.randn(*v.shape),
                                               np.float32) for v in vals]
                      for s, vals in ref.items()
                      if s not in opdef.no_grad_out_slots and vals
                      and all(isinstance(v, torch.Tensor)
                              and v.is_floating_point() for v in vals)}
                if og:
                    gop = op + "_grad"
                    gg = _run_op(torch, gop, case.inputs, case.attrs,
                                 "cuda", og)
                    gr = _run_op(torch, gop, case.inputs, case.attrs,
                                 "cpu", og)
                    bad += [f"grad {b}" for b in
                            _compare(torch, gg, gr, SWEEP_GRAD_TOL)]
                    grads += 1
            if bad:
                failed.setdefault(op, []).extend(bad)
    torch.cuda.synchronize()
    print(json.dumps({"phase": phase, "ops": len(ops),
                      "cases": n_cases, "gradient_cases": grads,
                      "tolerance": {"out": SWEEP_OUT_TOL,
                                    "grad": SWEEP_GRAD_TOL},
                      "failed": failed}), flush=True)
    if failed:
        fail(f"card op sweep: ops off tolerance on the card: "
             f"{sorted(failed)}: {failed}")
    return len(ops), n_cases


def _bert_feed(torch, cfg, batch, n_mask, device, seed=0):
    from paddle_tpu_torch.models.bert_static import bert_pretrain_batch
    return {k: torch.as_tensor(v, device=device) for k, v in
            bert_pretrain_batch(cfg, batch, BERT_SEQ, n_mask,
                                seed=seed).items()}


def _static_steps(torch, exe, main, loss, feed, steps):
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        lv = exe.run(main, feed=feed, fetch_list=[loss],
                     return_numpy=False)[0]
        losses.append(float(lv.reshape(-1)[0]))
        if exe.device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return losses, times


def static_bert_parity(torch):
    """(b) The static BERT program at full width and 2 layers (batch 4
    x 128, dropout 0, layer 1 the act-dropout variant at p = 0), 3 Lamb
    steps on the card and on the CPU from the same startup values:
    every loss within 1e-3 relative."""
    from paddle_tpu_torch.fluid import (CPUPlace, CUDAPlace, Executor,
                                        Scope, scope_guard)
    from paddle_tpu_torch.models.bert_static import (
        BertConfig, build_bert_pretrain_program)
    P = STATIC_BERT_PARITY
    cfg = BertConfig.base(num_hidden_layers=P["layers"])
    n_mask = P["batch"] * BERT_PRED
    main, startup, loss = build_bert_pretrain_program(
        cfg, P["batch"], BERT_SEQ, n_mask, lr=1e-3, dropout=0.0,
        act_dropout_layers=(1,), act_dropout=0.0)
    main.random_seed = startup.random_seed = 11
    cpu_scope = Scope()
    with scope_guard(cpu_scope):
        Executor(CPUPlace()).run(startup)
    card_scope = Scope()
    for n in cpu_scope.local_var_names():
        card_scope.set(n, cpu_scope.find_var(n).to("cuda"))
    out = {}
    for what, scope, place, dev in (("card", card_scope, CUDAPlace(0),
                                     "cuda"),
                                    ("cpu", cpu_scope, CPUPlace(), "cpu")):
        with scope_guard(scope):
            exe = Executor(place)
            out[what], _ = _static_steps(
                torch, exe, main, loss,
                _bert_feed(torch, cfg, P["batch"], n_mask, dev), P["steps"])
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["card"], out["cpu"]))
    print(json.dumps({"phase": "static_bert_parity",
                      "config": f"bert_base layers={P['layers']} batch="
                      f"{P['batch']}x{BERT_SEQ} masked={n_mask} f32 Lamb "
                      f"1e-3 dropout=0", "card_losses": out["card"],
                      "cpu_losses": out["cpu"], "max_rel": rel}),
          flush=True)
    if not rel <= P["rtol"]:
        fail(f"static BERT card and CPU losses differ: {out}")


def static_bert_run(torch, layers, act_layers, steps, what):
    """The static BERT program on Executor(CUDAPlace(0)) at bench_bert's
    shape (batch 16 x 128, 19 masked positions a sequence, the padding
    mask), dropout 0.1, Lamb 1e-3: `steps` steps on one batch. The loss
    must fall; every kernel must launch as static_bert_launches
    predicts, on its route. Returns the run's launch counts."""
    from paddle_tpu_torch.fluid import CUDAPlace, Executor, Scope, scope_guard
    from paddle_tpu_torch.models.bert_static import (
        BertConfig, build_bert_pretrain_program)
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg = BertConfig.base(num_hidden_layers=layers)
    n_mask = BERT_BATCH * BERT_PRED
    act = tuple(range(layers - act_layers, layers))
    t0 = time.perf_counter()
    main, startup, loss = build_bert_pretrain_program(
        cfg, BERT_BATCH, BERT_SEQ, n_mask, lr=1e-3, dropout=0.1,
        act_dropout_layers=act, act_dropout=0.1)
    main.random_seed = startup.random_seed = 5
    build_s = time.perf_counter() - t0
    feed = _bert_feed(torch, cfg, BERT_BATCH, n_mask, "cuda", seed=1)
    with scope_guard(Scope()):
        exe = Executor(CUDAPlace(0))
        exe.run(startup)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, times = _static_steps(torch, exe, main, loss, feed, steps)
        counts = launch_counts()
    want = {k: v * steps for k, v in static_bert_launches(
        layers, act_layers).items()}
    got = {k: counts.get(k, 0) for k in set(want) | {
        k for k in counts if k.split(".")[0] in {w.split(".")[0]
                                                 for w in want}}}
    print(json.dumps({
        "phase": what, "config": f"bert_base layers={layers} (act-dropout "
        f"layers {list(act)}) batch={BERT_BATCH}x{BERT_SEQ} masked="
        f"{n_mask} f32 Lamb 1e-3 dropout=0.1 padding mask",
        "ops": len(main.global_block().ops), "build_s": round(build_s, 3),
        "losses": losses, "step_ms": [round(t * 1e3, 3) for t in times],
        "step_ms_median": round(statistics.median(times[1:]) * 1e3, 3),
        "samples_per_s": round(BERT_BATCH / statistics.median(times[1:]),
                               2),
        "max_memory_allocated_gb": round(
            torch.cuda.max_memory_allocated() / 1e9, 3),
        "launches": counts, "launches_predicted": want,
        "executor": exe.stats()}), flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        fail(f"{what}: the loss did not fall: {losses}")
    wrong = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    extra = {k: v for k, v in got.items() if k not in want and v}
    if wrong or extra:
        fail(f"{what}: launches (got, predicted) {wrong}, unpredicted "
             f"{extra}")
    return counts


def static_paged_op(torch):
    """(e) The paged_attention op at GPT-3 XL decode (8 slots, 16 heads
    of 128, pages of 16, contexts up to 2048, f32 pools) through
    common_ops.run_op, equal to the row-1 wrapper's direct call; one
    launch, on the vector route. Returns its launch counts."""
    from paddle_tpu_torch.common_ops import run_op
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.ops.paged_attention import paged_attention_decode
    S, H, d, ps, M = 8, 16, 128, 16, 128
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(S, H, d, generator=g, device="cuda")
    kp = torch.randn(S * M, ps, H, d, generator=g, device="cuda")
    vp = torch.randn(S * M, ps, H, d, generator=g, device="cuda")
    table = torch.randperm(S * M, generator=g, device="cuda") \
        .reshape(S, M).int()
    ctx = torch.randint(1, M * ps + 1, (S,), generator=g, device="cuda",
                        dtype=torch.int32)
    direct = paged_attention_decode(q, kp, vp, table, ctx)
    torch.cuda.synchronize()
    reset_launch_counts()
    o = run_op("paged_attention", {"Q": q, "KCache": kp, "VCache": vp,
                                   "PageTable": table, "CtxLens": ctx})
    torch.cuda.synchronize()
    counts = launch_counts()
    err = max_err(o, direct)
    print(json.dumps({"phase": "static_bert_paged_op",
                      "shape": f"S={S} H={H} d={d} pages={ps}x{M} f32",
                      "launches": counts, "max_abs_err_vs_wrapper": err}),
          flush=True)
    if counts.get("paged_attention.vector", 0) != 1 or err != 0.0:
        fail(f"paged_attention op: {counts}, err {err} against the "
             f"wrapper's direct call")
    return counts


def static_bert_phase(torch):
    """Phase 11a: the op library on the card (a), the static BERT
    program card against CPU (b), BERT-base trained by Lamb on
    Executor(CUDAPlace(0)) (c), the act-dropout layer (d) and the
    paged_attention op (e). Returns the launch counts of (c) + (d) +
    (e) by kernel and route."""
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    pt.disable_static()
    card_op_sweep(torch)
    gc.collect()
    torch.cuda.empty_cache()
    static_bert_parity(torch)
    gc.collect()
    torch.cuda.empty_cache()
    counts = static_bert_run(torch, BERT_LAYERS, 0, STATIC_BERT_STEPS,
                             "static_bert_base")
    gc.collect()
    torch.cuda.empty_cache()
    variant = static_bert_run(torch, 2, 1, 2, "static_bert_act_dropout")
    paged = static_paged_op(torch)
    total = dict(counts)
    for c in (variant, paged):
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    print(json.dumps({"phase": "static_bert", "predicted_s":
                      STATIC_BERT_PREDICTED_S, "seconds": round(
                          time.perf_counter() - t0, 2)}), flush=True)
    return total


# ---------------------------------------------------------------------------
# static_lac: the op library's second part and the LAC tagger (item 11)
# ---------------------------------------------------------------------------

# the seconds the phase is predicted to take (written before its first
# run on the card): op sweep 10, full-width parity 15, 20 training steps
# 8, warpctc 4, the rest 3
STATIC_LAC_PREDICTED_S = 40.0
LAC_STEPS = 20
LAC_PARITY_STEPS = 3
LAC_PARITY_RTOL = 1e-4
LAC_TAGS_EQUAL = 0.999
# the averages at decay 0.8: the program's 0.999 starts its averages at
# 0 without a bias correction, as the reference's does, so after 20
# steps they would hold 1 - 0.999^20 = 2% of the weights
LAC_EMA_DECAY = 0.8
CTC_SHAPE = dict(batch=16, time=400, classes=29, max_label=100)


def _lac_cfg():
    sys.path.insert(0, os.path.join(HERE, "tests"))
    try:
        from torch_static_lac import LacConfig, build_lac_program, lac_batch
    finally:
        sys.path.pop(0)
    return LacConfig(ema_decay=LAC_EMA_DECAY), build_lac_program, lac_batch


def nce_on_card(torch):
    """nce on the card: its samples in range, and its cost equal to
    nce_cost on those samples on the CPU (the streams differ by
    device). Returns the failures."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    try:
        from torch_op_cases import LOSS_NCE
    finally:
        sys.path.pop(0)
    from paddle_tpu_torch.fluid.ops.structured_loss_ops import nce_cost
    bad = []
    for sampler in (0, 1):
        attrs = {"num_total_classes": 9, "num_neg_samples": 6,
                 "sampler": sampler}
        got = _run_op(torch, "nce", LOSS_NCE, attrs, "cuda")
        neg = got["SampleLabels"][0].cpu()
        if neg.min() < 0 or neg.max() >= 9:
            bad.append(f"sampler {sampler}: samples out of range")
        cost, _ = nce_cost(*(torch.as_tensor(LOSS_NCE[k]) for k in (
            "Input", "Label", "Weight", "Bias")), neg, 9, sampler)
        if not within(got["Cost"][0].cpu()[:, 0], cost, **SWEEP_OUT_TOL):
            bad.append(f"sampler {sampler}: cost "
                       f"{max_err(got['Cost'][0].cpu()[:, 0], cost):.3g}")
    return bad


def _lac_run(torch, p, exe, scope, feed, steps):
    """`steps` steps of the LAC program on `exe` in `scope`: (losses,
    decoded paths of each step, step seconds)."""
    from paddle_tpu_torch.fluid import scope_guard
    losses, paths, times = [], [], []
    with scope_guard(scope):
        for _ in range(steps):
            t0 = time.perf_counter()
            lv, path = exe.run(p.main, feed=feed,
                               fetch_list=[p.loss, p.path],
                               return_numpy=False)
            losses.append(float(lv.reshape(-1)[0]))
            paths.append(path.cpu())
            if exe.device.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return losses, paths, times


def static_lac_parity(torch):
    """(b) LAC at full width, 3 SGD steps on the card and on the CPU
    from the same startup values (the CPU's, copied to the card)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import (CPUPlace, CUDAPlace, Executor, Scope,
                                        scope_guard)
    cfg, build, batch = _lac_cfg()
    p = build(fluid, pt, cfg)
    feed = batch(cfg, seed=0)
    cpu = Scope()
    with scope_guard(cpu):
        Executor(CPUPlace()).run(p.startup)
    card = Scope()
    for n in cpu.local_var_names():
        card.set(n, cpu.find_var(n).to("cuda", copy=True))
    runs = {}
    for what, scope, place in (("card", card, CUDAPlace(0)),
                               ("cpu", cpu, CPUPlace())):
        runs[what] = _lac_run(torch, p, Executor(place), scope, feed,
                              LAC_PARITY_STEPS)
    (cl, cp, ct), (hl, hp, ht) = runs["card"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(cl, hl))
    live = torch.arange(cfg.seq)[None, :] < torch.as_tensor(
        feed["length"])[:, None]
    same = sum(int((a[live] == b[live]).sum()) for a, b in zip(cp, hp)) \
        / (len(cp) * int(live.sum()))
    print(json.dumps({
        "phase": "static_lac_parity",
        "config": f"LAC vocab={cfg.vocab} emb={cfg.emb} BiGRU "
        f"{cfg.layers}x{cfg.hidden} tags={cfg.tags} batch={cfg.batch}x"
        f"{cfg.seq} lengths {cfg.min_len}-{cfg.seq} f32 SGD {cfg.lr}",
        "card_losses": cl, "cpu_losses": hl, "max_rel": rel,
        "tags_equal": same, "tokens": int(live.sum()),
        "card_step_ms": [round(t * 1e3, 2) for t in ct],
        "cpu_step_ms": [round(t * 1e3, 2) for t in ht]}), flush=True)
    if not rel <= LAC_PARITY_RTOL:
        fail(f"LAC card and CPU losses differ by {rel:.3g} relative: "
             f"{cl} vs {hl}")
    if not same >= LAC_TAGS_EQUAL:
        fail(f"LAC card and CPU decode {same:.5f} of the tags equally")


def static_lac_train(torch):
    """(c) LAC trained LAC_STEPS steps on one batch on
    Executor(CUDAPlace(0)), and (d) the sparse update of its first
    step."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import CUDAPlace, Executor, Scope, scope_guard
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg, build, batch = _lac_cfg()
    t0 = time.perf_counter()
    p = build(fluid, pt, cfg)
    build_s = time.perf_counter() - t0
    feed = {k: torch.as_tensor(v, device="cuda")
            for k, v in batch(cfg, seed=0).items()}
    live = (torch.arange(cfg.seq, device="cuda")[None, :]
            < feed["length"][:, None])
    tags = feed["target"][live]
    majority = float(torch.bincount(tags).max()) / tags.numel()
    scope = Scope()
    with scope_guard(scope):
        exe = Executor(CUDAPlace(0))
        exe.run(p.startup)
        emb0 = scope.find_var(p.emb).clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what was live before the steps (earlier phases' tensors included):
    # the peak less this is the steps' own
    held = torch.cuda.memory_allocated()
    reset_launch_counts()
    losses, _, times = _lac_run(torch, p, exe, scope, feed, 1)
    emb1 = scope.find_var(p.emb).clone()
    more = _lac_run(torch, p, exe, scope, feed, LAC_STEPS - 1)
    losses += more[0]
    times += more[2]
    launches = launch_counts()
    with scope_guard(scope):
        raw = exe.run(p.main, feed=feed, fetch_list=[p.path],
                      use_prune=True, return_numpy=False)[0]
        with p.ema.apply(exe):
            ema = exe.run(p.main, feed=feed, fetch_list=[p.path],
                          use_prune=True, return_numpy=False)[0]
    acc = {k: float((v[live] == tags).float().mean())
           for k, v in (("raw", raw), ("ema", ema))}
    # (d): the rows no id touches keep their bits; each looked-up one
    # (inside a sequence) moved
    touched = torch.zeros(cfg.vocab, dtype=torch.bool, device="cuda")
    touched[feed["word"].reshape(-1)] = True
    words = torch.unique(feed["word"][live])
    kept = bool(torch.equal(emb1[~touched], emb0[~touched]))
    moved = bool((emb1[words] != emb0[words]).any(1).all())
    print(json.dumps({
        "phase": "static_lac_train",
        "config": f"LAC vocab={cfg.vocab} emb={cfg.emb} BiGRU "
        f"{cfg.layers}x{cfg.hidden} tags={cfg.tags} batch={cfg.batch}x"
        f"{cfg.seq} f32 SGD {cfg.lr} EMA {cfg.ema_decay}, one batch",
        "ops": len(p.main.global_block().ops), "build_s": round(build_s, 3),
        "losses": losses, "step_ms": [round(t * 1e3, 2) for t in times],
        "step_ms_median": round(statistics.median(times[1:]) * 1e3, 2),
        "tokens_per_s": round(int(live.sum())
                              / statistics.median(times[1:]), 1),
        "max_memory_allocated_gb": round(
            torch.cuda.max_memory_allocated() / 1e9, 3),
        "allocated_before_steps_gb": round(held / 1e9, 3),
        "tag_accuracy": acc, "majority_share": majority,
        "untouched_rows_bit_equal": kept, "looked_up_rows_moved": moved,
        "rows_looked_up": int(words.numel()), "launches": launches,
        "executor": exe.stats()}), flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        fail(f"static_lac: the loss did not fall: {losses}")
    if not acc["ema"] > majority:
        fail(f"static_lac: decoding under the EMA ({acc['ema']:.4f}) does "
             f"not beat the most frequent tag's share ({majority:.4f})")
    if not (kept and moved):
        fail(f"static_lac: sparse update: untouched rows bit-equal {kept}, "
             f"looked-up rows moved {moved}")
    if any(launches.values()):
        fail(f"static_lac: a kernel launched on a path that has none: "
             f"{launches}")


def warpctc_phase(torch):
    """(e) warpctc at a DeepSpeech2-like shape (CTC_SHAPE) on the card
    against the CPU: the loss, and its grad op's gradient for ones
    upstream."""
    import numpy as np
    S = CTC_SHAPE
    r = np.random.RandomState(5)
    B, T, C, L = S["batch"], S["time"], S["classes"], S["max_label"]
    llen = r.randint(T // 2, T + 1, B).astype(np.int64)
    tlen = np.minimum(r.randint(L // 2, L + 1, B), llen // 2).astype(
        np.int64)
    ins = {"Logits": r.randn(B, T, C).astype(np.float32),
           "Label": r.randint(1, C, (B, L)).astype(np.int32),
           "LogitsLength": llen, "LabelLength": tlen}
    og = {"Loss@GRAD": [np.ones((B, 1), np.float32)]}
    out, ms = {}, {}
    for where, d in (("card", "cuda"), ("cpu", "cpu")):
        for what, op, extra in (("loss", "warpctc", None),
                                ("grad", "warpctc_grad", og)):
            if d == "cuda":   # a warm-up call, then the timed one
                _run_op(torch, op, ins, {}, d, extra)
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = _run_op(torch, op, ins, {}, d, extra)
            if d == "cuda":
                torch.cuda.synchronize()
            ms[f"{where}_{what}"] = round((time.perf_counter() - t0) * 1e3,
                                          2)
            out[(where, what)] = (res["Loss"][0] if what == "loss"
                                  else res["Logits@GRAD"][0]).cpu()
    loss_rel = float(((out["card", "loss"] - out["cpu", "loss"]).abs()
                      / out["cpu", "loss"].abs()).max())
    g_rel = max_err(out["card", "grad"], out["cpu", "grad"]) \
        / float(out["cpu", "grad"].abs().max())
    print(json.dumps({"phase": "static_lac_warpctc",
                      "shape": f"B={B} T={T} classes={C} labels<={L}",
                      "loss_max_rel": loss_rel, "grad_max_rel": g_rel,
                      "ms": ms, "loss_mean": float(out["cpu", "loss"]
                                                   .mean())}), flush=True)
    if not (loss_rel <= 1e-4 and g_rel <= 1e-3):
        fail(f"warpctc card against CPU: loss {loss_rel:.3g} relative, "
             f"gradient {g_rel:.3g} of its largest entry")


def static_lac_phase(torch):
    """Phase 11b: the second part of the op library on the card (a),
    the full-width LAC tagger card against CPU (b), LAC trained on
    Executor(CUDAPlace(0)) with its sparse update (c, d), warpctc at
    DeepSpeech2's shape (e)."""
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    pt.disable_static()
    card_op_sweep(torch, OPS_SECOND, "static_lac_op_sweep")
    static_lac_parity(torch)
    gc.collect()
    torch.cuda.empty_cache()
    static_lac_train(torch)
    gc.collect()
    torch.cuda.empty_cache()
    warpctc_phase(torch)
    print(json.dumps({"phase": "static_lac", "predicted_s":
                      STATIC_LAC_PREDICTED_S, "seconds": round(
                          time.perf_counter() - t0, 2)}), flush=True)


def resnet_loss(m, img, label):
    from paddle_tpu_torch.nn import functional as F
    return F.cross_entropy(m(img), label)


def separable_batches(steps):
    """tests/test_vision_models.py's class-separable images: 4 fixed
    patterns plus noise, 16 fresh labels each step, 32 x 32."""
    import numpy as np
    rng = np.random.RandomState(0)
    protos = rng.randn(4, 3, 32, 32).astype("float32") * 2
    out = []
    for _ in range(steps):
        lab = rng.randint(0, 4, (16,))
        img = protos[lab] + rng.randn(16, 3, 32, 32).astype("float32") * .1
        out.append((img, lab[:, None].astype("int64")))
    return out


def resnet_parity(torch, steps=3, lr=0.01):
    """resnet18 (10 classes, NHWC, weights from the port's initialisers at
    seed 0) at 32 x 32, batch 8, f32: `steps` momentum steps through
    make_train_step on the card and the same steps on the CPU. Every
    step's loss must agree within 1e-3 relative and every running
    statistic within 1e-4 + 1e-4 relative. lr 0.01: at lr 0.1 on random
    labels the untrained net's loss climbs (4.4 to 14.5 in 3 steps) and
    two float32 sum orders part by 1% (seen on the CPU between the NCHW
    and NHWC trunks); at 0.01 they agree to 2e-5. Then under O1, on the
    card, the class-separable recipe (lr 0.01, 6 steps): the last loss
    below the first (at the reference test's lr 0.05 the loss swings
    from 0.01 to 16 between steps on the CPU)."""
    import math
    import numpy as np
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import initializer
    from paddle_tpu_torch.vision.models import resnet18
    rng = np.random.RandomState(0)
    batches = [(rng.randn(8, 3, 32, 32).astype("float32"),
                rng.randint(0, 10, (8, 1)).astype("int64"))
               for _ in range(steps)]
    initializer.seed(0)
    model = resnet18(num_classes=10, data_format="NHWC").train()
    runs = {}
    for dev in ("cuda", "cpu"):
        step = make_train_step(model, resnet_loss, optimizer="momentum",
                               lr=lr, device=dev)
        losses = [float(step(*(torch.as_tensor(a, device=dev)
                               for a in b))) for b in batches]
        runs[dev] = (losses, {n: v.cpu() for n, v in step.buffers.items()})
    (gl, gb), (cl, cb) = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    buf_err = max(max_err(gb[n], cb[n]) for n in gb)
    moved = sum(not torch.equal(gb[n], v) for n, v in
                model.named_buffers())
    bad = [n for n in gb if not within(gb[n], cb[n], 1e-4, 1e-4)]
    torch.cuda.empty_cache()
    initializer.seed(0)
    amp_model = resnet18(num_classes=4, data_format="NHWC").train()
    step = make_train_step(amp_model, resnet_loss, optimizer="momentum",
                           lr=lr, amp_level="O1")
    amp_losses = [float(step(*(torch.as_tensor(a, device="cuda")
                               for a in b)))
                  for b in separable_batches(6)]
    print(json.dumps({
        "phase": "resnet_parity", "config": "resnet18 NHWC 32x32 batch 8 "
        f"f32 momentum lr={lr}, card against CPU; O1 separable",
        "losses_cuda": gl, "losses_cpu": cl, "max_rel": rel,
        "buffers_max_abs_err": buf_err, "buffers_moved": moved,
        "buffers": len(gb), "o1_separable_losses": amp_losses}),
        flush=True)
    if not rel <= 1e-3:
        fail(f"resnet18 card and CPU losses differ: {gl} against {cl}")
    if bad:
        fail(f"resnet18 running statistics differ between card and CPU: "
             f"{bad[:4]} (max abs err {buf_err})")
    if moved != len(gb):
        fail(f"resnet18: {len(gb) - moved} running statistics did not move")
    if not all(math.isfinite(v) for v in amp_losses) \
            or not amp_losses[-1] < amp_losses[0]:
        fail(f"resnet18 O1 loss did not fall: {amp_losses}")


def resnet50_phase(torch, with_profile=False):
    """bench.py's bench_resnet50 through the port: resnet50 (1000
    classes, NHWC), make_train_step(optimizer="momentum", lr=0.1,
    amp_level="O1"), a batch of 256 x 3 x 224 x 224 from
    np.random.RandomState(0) with labels randint(0, 1000, (256, 1)),
    resident on the card; RESNET_WARMUP warm-up steps, then
    RESNET_STEPS steps each timed to a synchronize. The loss must stay
    finite, every running statistic must move, the stem's convolution
    must hand back an NHWC-contiguous tensor, and no kernel of the port
    launches (the launch counts of the timed steps are all zero)."""
    import math
    import numpy as np
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import initializer
    from paddle_tpu_torch.observability.perf import \
        resnet_train_flops_per_step
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.vision.models import resnet50
    t0 = time.perf_counter()
    initializer.seed(0)
    model = resnet50(num_classes=1000, data_format="NHWC").train()
    step = make_train_step(model, resnet_loss, optimizer="momentum",
                           lr=0.1, amp_level="O1")
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    img = torch.as_tensor(rng.randn(RESNET_BATCH, 3, 224, 224).astype(
        "float32"), device="cuda")
    lab = torch.as_tensor(rng.randint(0, 1000, (RESNET_BATCH, 1)).astype(
        "int64"), device="cuda")
    start = {n: v.clone() for n, v in step.buffers.items()}
    stem = []
    hook = model.stem[0].register_forward_hook(
        lambda mod, args, out: stem.append((tuple(out.shape), out.stride(),
                                            out.is_contiguous(), out.dtype)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = []
    for _ in range(RESNET_WARMUP):
        t0 = time.perf_counter()
        loss = float(step(img, lab))
        warm.append([loss, round((time.perf_counter() - t0) * 1e3, 3)])
    hook.remove()
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, times = [], []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        loss = step(img, lab)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = launch_counts()
    step_s = statistics.median(times)
    flops = resnet_train_flops_per_step(RESNET_BATCH)
    moved = {n: float((step.buffers[n] - v).abs().max())
             for n, v in start.items()}
    main_d = {
        "phase": "resnet50_phase", "config": "bench_resnet50: resnet50 "
        "NHWC, 1000 classes, momentum lr=0.1, O1", "batch": RESNET_BATCH,
        "image": [3, 224, 224], "init_s": round(init_s, 2),
        "warmup_loss_ms": warm, "losses": losses,
        "step_ms": [round(t * 1e3, 3) for t in times],
        "step_ms_median": round(step_s * 1e3, 3),
        "images_per_s": round(RESNET_BATCH / step_s, 2),
        "mfu_bf16": round(flops / step_s / BF16_FLOPS, 5),
        "flops_per_step": flops,
        "max_memory_allocated_gb": round(
            torch.cuda.max_memory_allocated() / 1e9, 3),
        "max_memory_requested_gb": round(torch.cuda.memory_stats()[
            "requested_bytes.all.peak"] / 1e9, 6),
        "stem_output": {"shape": stem[0][0], "stride": stem[0][1],
                        "contiguous": stem[0][2], "dtype": str(stem[0][3])},
        "buffers": len(moved),
        "buffers_moved": sum(v > 0 for v in moved.values()),
        "buffer_max_abs_change": max(moved.values()),
        "port_launches": counts}
    print(json.dumps(main_d), flush=True)
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite ResNet-50 loss: {losses}")
    if not stem[0][2] or stem[0][0] != (RESNET_BATCH, 112, 112, 64):
        fail(f"ResNet-50 stem output not NHWC-contiguous: {stem[0]}")
    if main_d["buffers_moved"] != len(moved):
        fail(f"ResNet-50: {len(moved) - main_d['buffers_moved']} running "
             f"statistics did not move")
    if any(counts.values()):
        fail(f"ResNet-50 launched kernels of the port: {counts}")
    if with_profile:
        table = profile_steps(torch, lambda: step(img, lab), 1,
                              "resnet50_train_step", top_n=16)
        kinds = {"layout": LAYOUT_KERNELS, "copy": COPY_KERNELS}
        row = {"phase": "resnet50_layout",
               "busy_ms": round(sum(v[0] for v in table.values()), 3)}
        for kind, words in kinds.items():
            hit = {k: v for k, v in table.items()
                   if any(w in k for w in words)}
            row[f"{kind}_kernels"] = {
                k: {"ms": round(v[0], 4), "launches": v[1]}
                for k, v in sorted(hit.items(), key=lambda kv: -kv[1][0])}
            row[f"{kind}_ms"] = round(sum(v[0] for v in hit.values()), 4)
        print(json.dumps(row), flush=True)


def widedeep_parity(torch, steps=3, tol=1e-4):
    """WideDeepConfig.tiny(), batch 64, Adam lr 1e-3: `steps` steps of
    WideDeepTrainStep on the card and the same on the CPU, from the same
    seed and batches. Every loss within `tol` relative, every parameter
    and both Adam moments within `tol` relative (+ 1e-6)."""
    import numpy as np
    from paddle_tpu_torch.models.wide_deep import (WideDeepConfig,
                                                   WideDeepTrainStep,
                                                   _leaves)
    cfg = WideDeepConfig.tiny()
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(steps):
        ids = rng.randint(0, cfg.vocab_size, (64, cfg.num_slots))
        batches.append((ids, rng.randn(64, cfg.dense_dim).astype(
            np.float32), (ids[:, 0] % 2).astype(np.float32)[:, None]))
    runs = {}
    for dev in ("cuda", "cpu"):
        step = WideDeepTrainStep(cfg, device=dev)
        losses = [float(step(*b)) for b in batches]
        state = _leaves(step.params) + [m for st in _leaves(step.opt_state)
                                        for m in (st["m1"], st["m2"])]
        runs[dev] = (losses, [t.cpu() for t in state])
    (gl, gs), (cl, cs) = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    err = max(max_err(a, b) for a, b in zip(gs, cs))
    bad = sum(not within(a, b, 1e-6, tol) for a, b in zip(gs, cs))
    print(json.dumps({"phase": "widedeep_parity", "config": "tiny, batch "
                      f"64, adam lr 1e-3, {steps} steps, card against CPU",
                      "losses_cuda": gl, "losses_cpu": cl, "max_rel": rel,
                      "state_max_abs_err": err, "tensors": len(gs),
                      "tensors_outside": bad}), flush=True)
    if not rel <= tol or bad:
        fail(f"wide&deep card and CPU differ: losses {gl} against {cl}, "
             f"{bad} of {len(gs)} parameters or moments outside {tol}")


def widedeep_phase(torch, with_profile=False):
    """bench.py's bench_widedeep headline path whole: WideDeepConfig()
    (1,048,576-row hashed vocab, 26 slots, embed 16, 13 dense features,
    hidden 400-400-400), WideDeepTrainStep(dp=1, mp=1), Adam lr 1e-3,
    f32, batch WD_BATCH of the bench's seeded ids, dense features and
    ids[:, 0] % 2 labels, handed over as numpy arrays each step as the
    bench does. WD_WARMUP warm-up steps, then WD_STEPS timed ones: the
    bench's examples/s (one synchronize after the block) and the median
    of the steps' spans between CUDA events. Then the same count of
    steps on inputs already on the card (resident_*). The loss must be
    finite and lower after the warm-up and timed steps than after the
    first, and no kernel of the port launches."""
    import numpy as np
    from paddle_tpu_torch.models.wide_deep import (WideDeepConfig,
                                                   WideDeepTrainStep)
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg = WideDeepConfig()
    t0 = time.perf_counter()
    step = WideDeepTrainStep(cfg, dp=1, mp=1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (WD_BATCH, cfg.num_slots))
    dense = rng.randn(WD_BATCH, cfg.dense_dim).astype(np.float32)
    label = (ids[:, 0] % 2).astype(np.float32)[:, None]
    torch.cuda.reset_peak_memory_stats()
    losses = [step(ids, dense, label) for _ in range(WD_WARMUP)]
    torch.cuda.synchronize()
    reset_launch_counts()

    def block(args):
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(WD_STEPS + 1)]
        out = []
        t0 = time.perf_counter()
        marks[0].record()
        for i in range(WD_STEPS):
            out.append(step(*args))
            marks[i + 1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return out, wall, statistics.median(spans)

    timed, wall, med = block((ids, dense, label))
    counts = launch_counts()
    losses = [float(v) for v in losses + timed]
    dev = [torch.as_tensor(a, device=step.device)
           for a in (ids, dense, label)]
    _, r_wall, r_med = block(dev)
    row = {
        "phase": "widedeep_phase", "config": "bench_widedeep: vocab "
        f"{cfg.vocab_size}, {cfg.num_slots} slots, embed {cfg.embed_dim}, "
        f"{cfg.dense_dim} dense, hidden {list(cfg.hidden)}, f32, adam "
        "lr 1e-3, dense tables", "batch": WD_BATCH,
        "warmup": WD_WARMUP, "steps": WD_STEPS, "init_s": round(init_s, 3),
        "losses": losses,
        "examples_per_s": round(WD_BATCH * WD_STEPS / wall, 1),
        "step_ms_median": round(med, 4),
        "resident_examples_per_s": round(WD_BATCH * WD_STEPS / r_wall, 1),
        "resident_step_ms_median": round(r_med, 4),
        "max_memory_allocated_gb": round(
            torch.cuda.max_memory_allocated() / 1e9, 3),
        "max_memory_requested_gb": round(torch.cuda.memory_stats()[
            "requested_bytes.all.peak"] / 1e9, 6),
        "port_launches": counts}
    MEASURED["widedeep_examples_per_s"] = row["examples_per_s"]
    print(json.dumps(row), flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        fail(f"wide&deep loss did not fall: {losses}")
    if any(counts.values()):
        fail(f"wide&deep launched kernels of the port: {counts}")
    if with_profile:
        profile_steps(torch, lambda: step(ids, dense, label), 3,
                      "widedeep_train_step", top_n=16)


# ---------------------------------------------------------------------------
# data parallelism (item 14(a)): two ranks on the one card over gloo
# ---------------------------------------------------------------------------

# the thread-pool sizes a rank's libraries read when they start
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def dp_worker(cases, out_dir):
    """One rank of a world of ranks on the card, started by the port's
    distributed.spawn: joins the process group from the PADDLE_* env
    (ranks sharing a card: gloo with CUDA tensors), runs each (label,
    case, args) of `cases` in order (DP_CASES[case](torch, *args), the
    card's cache emptied between them) and pickles {label: result} to
    <out_dir>/rank<r>.pkl. The kernels are the ones the parent built; a
    build here is recorded and fails the phase."""
    import pickle
    t_enter = time.time()

    import torch
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.models.gpt import disable_tf32
    from paddle_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        raise RuntimeError("a data-parallel rank found no CUDA card")
    penv = env.init_parallel_env()
    disable_tf32()
    # wall clock: the parent holds these against its spawn's start
    timeline = {"enter": t_enter, "ready": time.time()}
    res = {}
    for label, case, args in cases:
        res[label] = DP_CASES[case](torch, *args)
        gc.collect()
        torch.cuda.empty_cache()
        timeline[label] = time.time()
    res["timeline"] = timeline
    res["backend"] = penv.backend
    res["device"] = str(torch.device("cuda", torch.cuda.current_device()))
    res["built_here"] = sorted(_build.build_log())
    with open(os.path.join(out_dir, f"rank{penv.rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def run_world(cases, nprocs, timeout):
    """dp_worker's `cases` on `nprocs` ranks of the one card, in one
    spawn; each rank's {label: result}, rank by rank. A rank that fails
    or outlives `timeout` fails the run (spawn terminates the others).
    One line with where the world's wall went: spawn -> each rank's
    entry, -> its process group (torch imported, gloo joined), -> each
    case's end; and the last rank reaped."""
    import pickle
    import shutil
    import tempfile
    from paddle_tpu_torch.distributed import spawn
    labels = [label for label, _, _ in cases]
    out = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    # each rank's share of the host's cores for its CPU thread pools
    # (torch's, BLAS's): with every core each, the ranks of a world
    # oversubscribe the host nprocs times over
    threads = str(max(1, (os.cpu_count() or 1) // nprocs))
    saved = {k: os.environ.get(k) for k in THREAD_VARS}
    os.environ.update({k: threads for k in THREAD_VARS})
    try:
        t0 = time.time()
        try:
            spawn(dp_worker, args=(cases, out), nprocs=nprocs,
                  timeout=timeout)
        except RuntimeError as e:
            fail(f"data-parallel world {labels}: {e}")
        t_end = time.time()
        res = []
        for r in range(nprocs):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
    finally:
        shutil.rmtree(out, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    tl = [rank["timeline"] for rank in res]
    print(json.dumps({
        "phase": "spawn", "cases": labels, "ranks": nprocs,
        "threads_per_rank": int(threads), "wall_s": round(t_end - t0, 2),
        **{f"{k}_s": [round(t[k] - t0, 2) for t in tl]
           for k in ("enter", "ready", *labels)}}), flush=True)
    for r, rank in enumerate(res):
        if rank["built_here"] or rank["backend"] != "gloo" \
                or not rank["device"].startswith("cuda"):
            fail(f"{labels} rank {r}: backend {rank['backend']}, device "
                 f"{rank['device']}, kernels built in the rank "
                 f"{rank['built_here']} (want gloo, cuda, none)")
    return res


def world_phases(nprocs, phases):
    """Phases that each need a world of `nprocs` ranks, run in one
    world: a rank's start (torch, a CUDA context, gloo) and its first
    steps' warm-up cost 20-40 s on the card, paid once. Each phase is
    (name, prepare, args): prepare(*args) runs here first (its
    single-rank references) and returns (cases, seconds, report): the
    phase's dp_worker cases, their time limit, and report(ranks), which
    checks and prints the phase's lines from each rank's {label: result}
    and returns the phase's result. One seconds line a phase (its
    preparation and report; the shared world's own line is "spawn").
    Returns {name: result}."""
    done = []
    for name, prepare, args in phases:
        t0 = time.perf_counter()
        cases, seconds, report = prepare(*args)
        done.append((name, cases, seconds, report,
                     time.perf_counter() - t0))
    ranks = run_world([(f"{name}/{label}", case, cargs)
                       for name, cases, _, _, _ in done
                       for label, case, cargs in cases], nprocs,
                      sum(d[2] for d in done))
    out = {}
    for name, cases, _, report, prep_s in done:
        t0 = time.perf_counter()
        out[name] = report([{label: r[f"{name}/{label}"]
                             for label, _, _ in cases} for r in ranks])
        print(json.dumps({"phase": "seconds", "of": name, "seconds": round(
            prep_s + time.perf_counter() - t0, 2), "world": nprocs}),
            flush=True)
    return out


def _timed_sync(torch, fn, spent):
    """fn wrapped so that the wall of each call, the card drained
    before and after, adds to spent[0]."""
    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
    return wrapped


def bert_dp_steps(torch, dropout, steps, mesh=None, sync=None):
    """bench_bert's step (BERT-base, seed-0 weights, AdamW 1e-4, O1) on
    the global batch 16 x 128: losses, step seconds and the launch
    counts of the steps (set to 0 just before them)."""
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg, model = bert_model(BERT_LAYERS, dropout=dropout)
    step = make_train_step(model, bert_loss_fn, optimizer="adamw", lr=1e-4,
                           amp_level="O1", mesh=mesh)
    batch = bert_batch(cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times, syncs = [], [], []
    for _ in range(steps):
        if sync is not None:
            sync[0] = 0.0
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if sync is not None:
            syncs.append(sync[0])
    return {"losses": losses, "times": times, "syncs": syncs,
            "counts": launch_counts(),
            "peak_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}


def dp_bert_case(torch, steps):
    """A rank of bert_dp: the step at dropout 0, then at dropout 0.1
    with the gradient all-reduce timed (the card drained around it)."""
    from paddle_tpu_torch.distributed import make_mesh
    from paddle_tpu_torch.jit import functional as jf
    mesh = make_mesh({"dp": DP_RANKS})
    p0 = bert_dp_steps(torch, 0.0, steps, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    spent = [0.0]
    real = jf.all_reduce_buckets
    jf.all_reduce_buckets = _timed_sync(torch, real, spent)
    try:
        p1 = bert_dp_steps(torch, 0.1, steps, mesh, spent)
    finally:
        jf.all_reduce_buckets = real
    return {"p0": p0, "p1": p1}


def bert_dp_prepare(torch, dp1_samples_per_s, steps=5):
    """bench_bert's configuration at dp = 2 through TrainStep(mesh=
    make_mesh({"dp": 2})): two ranks on the card over gloo, each on its
    8 of the global 16 sequences. At dropout 0 the losses must agree
    with a dp = 1 run on the card (same weights and global batch) within
    1e-3 relative; at dropout 0.1: step ms (median of 4), global
    samples/s beside phase 8's dp = 1 figure, each rank's peak memory
    and the all-reduce's share of the step; rows 2-5 and 8-9 must launch
    on both ranks, as often on each (world_phases' prepare; its report
    returns each rank's counts of the dropout-0.1 run)."""
    import math
    one = bert_dp_steps(torch, 0.0, steps)
    gc.collect()
    torch.cuda.empty_cache()

    def report(ranks):
        ranks = [r["bert"] for r in ranks]
        rel = max(abs(a - b) / abs(b) for r in ranks
                  for a, b in zip(r["p0"]["losses"], one["losses"]))
        p1 = [r["p1"] for r in ranks]
        step_s = statistics.median(max(t) for t in zip(*(p["times"][1:]
                                                         for p in p1)))
        sync_share = [statistics.median(s / t for s, t in zip(
            p["syncs"][1:], p["times"][1:])) for p in p1]
        dp_counts = [{k: p["counts"].get(k, 0)
                      for k in BERT_LAUNCHES_PER_STEP} for p in p1]
        main = {"phase": "bert_dp", "config": "bert_base O1 adamw lr=1e-4",
                "dp": DP_RANKS, "transport": "gloo, 2 ranks on one card",
                "batch": BERT_BATCH, "seq": BERT_SEQ,
                "dp1_losses_p0": one["losses"],
                "dp2_losses_p0": [r["p0"]["losses"] for r in ranks],
                "max_rel_p0": rel, "rtol": 1e-3,
                "dp2_losses_p01": [p["losses"] for p in p1],
                "step_ms": [[round(t * 1e3, 3) for t in p["times"]]
                            for p in p1],
                "step_ms_median": round(step_s * 1e3, 3),
                "samples_per_s": round(BERT_BATCH / step_s, 2),
                "dp1_samples_per_s": dp1_samples_per_s,
                "allreduce_ms": [[round(s * 1e3, 3) for s in p["syncs"]]
                                 for p in p1],
                "allreduce_share": [round(s, 4) for s in sync_share],
                "peak_gb": [p["peak_gb"] for p in p1],
                "launches": dp_counts}
        print(json.dumps(main), flush=True)
        MEASURED["bert_dp_step_ms"] = main["step_ms_median"]
        if not rel <= 1e-3 or not all(math.isfinite(x) for p in p1
                                      for x in p["losses"]):
            fail(f"bert_dp: dp = 2 losses off the dp = 1 run (max rel {rel}) "
                 f"or not finite: {main}")
        if any(n <= 0 for c in dp_counts for n in c.values()) \
                or dp_counts[0] != dp_counts[1]:
            fail(f"bert_dp: rows 2-5 and 8-9 not launched alike on both "
                 f"ranks: {dp_counts}")
        return dp_counts

    return [("bert", "bert", (steps,))], 300, report


def conv_bn_net():
    """conv 3->8 (3 x 3) -> batch norm -> relu -> global average pool ->
    fc 8->5 from the port's layers, seeded initialisers (the net of
    tests/test_torch_data_parallel.py)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import initializer

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 8, 3, padding=1, bias_attr=False)
            self.bn = nn.BatchNorm2D(8)
            self.relu = nn.ReLU()
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
            self.flatten = nn.Flatten()
            self.fc = nn.Linear(8, 5)

        def forward(self, x):
            h = self.relu(self.bn(self.conv(x)))
            return self.fc(self.flatten(self.pool(h)))

    initializer.seed(5)
    return Net()


def conv_bn_batches():
    """Three global batches of 8 images 16 x 16; the second half shifted
    by +1.5, so the two ranks' channel means differ."""
    import numpy as np
    out = []
    for i in range(3):
        rs = np.random.RandomState(20 + i)
        img = rs.randn(8, 3, 16, 16).astype("float32")
        img[4:] += 1.5
        out.append((img, rs.randint(0, 5, (8, 1)).astype("int64")))
    return out


def conv_bn_steps(torch, mesh=None):
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import functional as F
    net = conv_bn_net().train()
    step = make_train_step(
        net, lambda m, img, lab: F.cross_entropy(m(img), lab),
        optimizer="momentum", lr=0.1, mesh=mesh)
    losses = [float(step(img, lab)) for img, lab in conv_bn_batches()]
    step.write_back()
    return losses, {n: v.detach().cpu().numpy()
                    for n, v in net.state_dict().items()}


def regression_program():
    """tests/test_data_parallel.py's program with the port's fluid: x
    (-1, 8) -> fc 16 relu -> fc 1, mean squared error, SGD 0.05."""
    from paddle_tpu_torch import fluid
    fw, layers = fluid.framework, fluid.layers
    main, startup = fw.Program(), fw.Program()
    main.random_seed = startup.random_seed = 7
    with fw.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data("x", [-1, 8], "float32")
        y = layers.data("y", [-1, 1], "float32")
        h = layers.fc(x, 16, act="relu")
        d = layers.elementwise_sub(layers.fc(h, 1), y)
        loss = layers.mean(layers.elementwise_mul(d, d))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def regression_losses(torch, start, parallel, steps=20):
    """20 steps of the regression from the scope `start` on the card,
    data-parallel through CompiledProgram.with_data_parallel or not."""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fluid import (CUDAPlace, Executor,
                                        scope_from_numpy, scope_guard)
    from paddle_tpu_torch.fluid.compiler import CompiledProgram
    pt.enable_static()
    try:
        main, _, loss = regression_program()
        prog = CompiledProgram(main).with_data_parallel(loss.name) \
            if parallel else main
        rng = np.random.RandomState(3)
        w_true = rng.randn(8, 1).astype("float32")
        losses = []
        with scope_guard(scope_from_numpy(start, CUDAPlace(0))):
            exe = Executor(CUDAPlace(0))
            for _ in range(steps):
                xb = rng.randn(64, 8).astype("float32")
                losses.append(float(exe.run(
                    prog, feed={"x": xb, "y": xb @ w_true},
                    fetch_list=[loss])[0][0]))
        return losses
    finally:
        pt.disable_static()


def dp_parity_case(torch, start):
    from paddle_tpu_torch.distributed import make_mesh
    losses, state = conv_bn_steps(torch, make_mesh({"dp": DP_RANKS}))
    return {"conv_losses": losses, "conv_state": state,
            "static_losses": regression_losses(torch, start, True)}


def dp_parity_prepare(torch):
    """dp = 2 against dp = 1 on the card, small: the conv-BN net in
    training mode, 3 momentum steps (losses, parameters and running
    statistics within 1e-4 + 1e-4 relative), and the static regression
    program through CompiledProgram.with_data_parallel, 20 SGD steps
    from one initial scope (losses within 2e-3 relative); world_phases'
    prepare."""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fluid import CUDAPlace, Executor, Scope, scope_guard
    pt.enable_static()
    try:
        main, startup, _ = regression_program()
        scope = Scope()
        with scope_guard(scope):
            Executor(CUDAPlace(0)).run(startup)
        start = {n: scope.numpy(n) for n in scope.local_var_names()}
    finally:
        pt.disable_static()
    one_losses, one_state = conv_bn_steps(torch)
    one_static = regression_losses(torch, start, False)

    def report(ranks):
        ranks = [r["parity"] for r in ranks]
        conv_err = max(float(np.max(np.abs(r["conv_state"][n] - v)
                                    / (1e-4 + 1e-4 * np.abs(v))))
                       for r in ranks for n, v in one_state.items())
        loss_err = max(abs(a - b) / (1e-4 + 1e-4 * abs(b)) for r in ranks
                       for a, b in zip(r["conv_losses"], one_losses))
        static_rel = max(abs(a - b) / abs(b) for r in ranks
                         for a, b in zip(r["static_losses"], one_static))
        main = {"phase": "dp_parity", "dp": DP_RANKS,
                "transport": "gloo, 2 ranks on one card",
                "conv_bn_losses_dp1": one_losses,
                "conv_bn_losses_dp2": [r["conv_losses"] for r in ranks],
                "conv_bn_err_over_tol": max(conv_err, loss_err),
                "static_losses_dp1": one_static,
                "static_losses_dp2": [r["static_losses"] for r in ranks],
                "static_max_rel": static_rel, "static_rtol": 2e-3}
        print(json.dumps(main), flush=True)
        if not max(conv_err, loss_err) <= 1.0 or not static_rel <= 2e-3:
            fail(f"dp_parity: dp = 2 off dp = 1 on the card: {main}")

    return [("parity", "parity", (start,))], 300, report


def dp_allreduce_case(torch, mb, warmup, steps):
    from paddle_tpu_torch.distributed import collective, make_mesh
    group = make_mesh({"dp": DP_RANKS}).group("dp")
    x = torch.ones(mb * 1024 * 1024 // 4, device="cuda")
    for _ in range(warmup):
        collective.all_reduce(x, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        collective.all_reduce(x, group=group)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    return {"seconds": dt, "value": float(x[0])}


def allreduce_prepare(torch, mb=64, warmup=5, steps=30):
    """bench.py's bench_allreduce over the dp group: 64 MB of f32 on the
    card, 5 warm-up and 30 timed all-reduces; algorithmic bandwidth
    2 (n - 1) / n bytes / time, as bench.py computes it. Two ranks on
    one card over gloo: a host-path figure, not NCCL's or NVLink's;
    world_phases' prepare."""

    def report(ranks):
        ranks = [r["allreduce"] for r in ranks]
        n = DP_RANKS
        # ones summed over n, repeatedly
        want = float(n ** (warmup + steps))
        dt = max(r["seconds"] for r in ranks)
        bw = 2 * (n - 1) / n * mb * 1024 * 1024 / dt / 1e9
        main = {"phase": "allreduce", "metric": "allreduce_algbw_gbps",
                "value": round(bw, 3), "unit": "GB/s", "ranks": n,
                "payload_mb": mb, "ms_per_call": round(dt * 1e3, 3),
                "transport": "gloo, 2 ranks on one card (host path; not an "
                             "NCCL or NVLink figure)"}
        print(json.dumps(main), flush=True)
        if any(r["value"] != want for r in ranks):
            fail(f"allreduce: the sum is off: {[r['value'] for r in ranks]} "
                 f"against {want}")

    return [("allreduce", "allreduce", (mb, warmup, steps))], 300, report


# ---------------------------------------------------------------------------
# hybrid GPT (item 14(b)): dp x pp x tp ranks on the one card over gloo
# ---------------------------------------------------------------------------

def save_tree(tree, root):
    """The numpy weight tree as one .npy a leaf under `root`."""
    import numpy as np
    for k, v in tree.items():
        if k == "blocks":
            for b, w in v.items():
                np.save(os.path.join(root, f"blocks.{b}.npy"), w)
        else:
            np.save(os.path.join(root, f"{k}.npy"), v)


def load_tree(root, layers=None):
    """save_tree's tree as read-only memmaps (a rank reads only the
    pieces it holds), block leaves cut to the first `layers`."""
    import numpy as np
    tree = {"blocks": {}}
    for name in os.listdir(root):
        v = np.load(os.path.join(root, name), mmap_mode="r")
        key = name[:-len(".npy")]
        if key.startswith("blocks."):
            tree["blocks"][key[7:]] = v[:layers] if layers else v
        else:
            tree[key] = v
    return tree


def hybrid_run(torch, cfg, kw, params, ids, steps, probe=()):
    """`steps` calls of HybridParallelTrainStep(cfg, **kw) from
    `params` on the global batch `ids`, launch counts set to 0 just
    before and read just after: losses, step seconds, the step's comm
    seconds (last_stats) a step, peak memory, moment bytes, counts.
    With `probe` (leaf names), first one loss_and_grads on `params`
    without an update: the global norm the clip takes and this rank's
    reduced gradients of those leaves ("probe")."""
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.parallel import HybridParallelTrainStep
    t0 = time.perf_counter()
    step = HybridParallelTrainStep(cfg, grad_clip_norm=1.0, params=params,
                                   **{"n_microbatches": HYBRID_MICRO, **kw})
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    probed = None
    if probe:
        grads = step.loss_and_grads(ids)[1]
        probed = {"norm": float(step._global_norm(grads)), "grads": {
            n: g.float().cpu().numpy() for (n, _), g in
            zip(step._leaves, grads) if n in probe}}
        del grads
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times, stats = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        stats.append(dict(step.last_stats))
    res = {"losses": losses, "times": times, "stats": stats,
           "counts": launch_counts(), "load_s": load_s,
           "moment_bytes": step.moment_bytes(),
           "unsharded_moment_bytes": 8 * sum(
               p.numel() for _, p in step._leaves),
           "zero": step.zero_sharding,
           "leaf_bytes": {n: p.numel() * p.element_size()
                          for n, p in step._leaves},
           "coords": {a: step.mesh.coord(a) for a in step.mesh.axis_names},
           "probe": probed,
           "peak_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tree_root(tree, what):
    """`tree` saved (save_tree) under a new temporary directory, which
    the caller removes; one line with the seconds and GB."""
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_tree_")
    t0 = time.perf_counter()
    save_tree(tree, root)
    print(json.dumps({"phase": what, "seconds": round(
        time.perf_counter() - t0, 2), "gb": round(sum(
            os.path.getsize(os.path.join(root, n))
            for n in os.listdir(root)) / 1e9, 3)}), flush=True)
    return root


def hybrid_a_prepare(torch, root, L):
    """(a) GPT-3 XL (L layers, the tree under `root`) at pp x tp under
    both schedules against single-rank steps (module docstring, phase
    16); world_phases' prepare (4 ranks). Its report returns each
    rank's launch counts of the 1F1B run, for the kernels line."""
    cfg_a = dict(XL, num_layers=L, **HYBRID_CFG)
    ref_a = gpt_run(torch, root, cfg_a, {}, HYBRID_A_BATCH, TRAIN_TOKENS,
                    HYBRID_A_STEPS)
    runs = [(sched, cfg_a, dict(HYBRID_A, pipeline_schedule=sched),
             HYBRID_A_BATCH, TRAIN_TOKENS, HYBRID_A_STEPS)
            for sched in ("1F1B", "F-then-B")]

    def report(ranks):
        ranks_a = [r["a"] for r in ranks]
        want = mesh_launches(L, HYBRID_A["pp"], HYBRID_MICRO,
                             HYBRID_A_STEPS)
        for sched in ("1F1B", "F-then-B"):
            check(mesh_report("hybrid_gpt", f"a {sched}", sched, ranks_a,
                              ref_a, HYBRID_A, HYBRID_A_BATCH, TRAIN_TOKENS,
                              want, mesh_routes(want),
                              micro=HYBRID_MICRO)[1])
        return [rank["1F1B"]["counts"] for rank in ranks_a]

    return [("a", "gpt", (root, runs))], 600, report


def hybrid_b_prepare(torch, root):
    """(b) HYBRID_B_LAYERS at dp x pp x tp with ZeRO-1 against the
    single rank, then once at dropout 0.1 (module docstring, phase 16);
    world_phases' prepare (8 ranks)."""
    Lb = HYBRID_B_LAYERS
    cfg_b = dict(XL, num_layers=Lb, **HYBRID_CFG)
    ref_b = gpt_run(torch, root, cfg_b, {}, HYBRID_B_BATCH, TRAIN_TOKENS)
    kw = dict(HYBRID_B, sharding=True)
    runs = [("zero", cfg_b, kw, HYBRID_B_BATCH, TRAIN_TOKENS),
            ("dropout", dict(cfg_b, dropout=0.1), kw, HYBRID_B_BATCH,
             TRAIN_TOKENS, 1)]

    def report(ranks):
        ranks_b = [r["b"] for r in ranks]
        want = mesh_launches(Lb, HYBRID_B["pp"], HYBRID_MICRO)
        bad = mesh_report("hybrid_gpt", "b ZeRO-1", "zero", ranks_b, ref_b,
                          HYBRID_B, HYBRID_B_BATCH, TRAIN_TOKENS, want,
                          mesh_routes(want), micro=HYBRID_MICRO)[1]
        want = mesh_launches(Lb, HYBRID_B["pp"], HYBRID_MICRO, steps=1)
        bad += mesh_report("hybrid_gpt", "b dropout 0.1", "dropout",
                           ranks_b, None, HYBRID_B, HYBRID_B_BATCH,
                           TRAIN_TOKENS, want, mesh_routes(want),
                           micro=HYBRID_MICRO)[1]
        dp = HYBRID_B["dp"]
        for r, rank in enumerate(ranks_b):
            got = rank["zero"]
            if not got["zero"] or got["moment_bytes"] * dp != \
                    got["unsharded_moment_bytes"]:
                bad.append(f"hybrid b rank {r}: moment bytes "
                           f"{got['moment_bytes']} not 1/{dp} of "
                           f"{got['unsharded_moment_bytes']}")
        check(bad)

    return [("b", "gpt", (root, runs))], 600, report


# ---------------------------------------------------------------------------
# item 14(c): ring attention over sp, experts over ep, sharded tables
# ---------------------------------------------------------------------------

# GPT-3 XL's widths (GPTConfig.gpt3_1p3b)
XL = dict(hidden_size=2048, num_heads=16, max_position_embeddings=2048)


def gpt_ids(vocab: int, batch: int, seq: int, seed: int = 0):
    import numpy as np
    return np.random.RandomState(seed).randint(
        0, vocab, (batch, seq)).astype(np.int32)


class RouteTap:
    """Keeps the first routing decision moe_ffn makes in this process
    while open (layer 0's forward in the first step): round 0's expert
    of each of the rank's tokens and whether it fit, on the host."""

    def __enter__(self):
        from paddle_tpu_torch.parallel import moe
        self.mod, self.orig, self.first = moe, moe._route, None

        def tapped(*args, **kw):
            out = self.orig(*args, **kw)
            if self.first is None:
                self.first = (out[0][0].cpu().numpy(),
                              out[2][0].cpu().numpy())
            return out

        moe._route = tapped
        return self

    def __exit__(self, *exc):
        self.mod._route = self.orig


def gpt_run(torch, root, cfg_kw, kw, batch, seq, steps=HYBRID_STEPS,
            seed=0, probe=()):
    """hybrid_run of GPTConfig(**cfg_kw) from the tree under `root` on
    the [batch, seq] ids of `seed` (with `probe`); with experts, layer
    0's first routing ("route0": experts, kept) beside."""
    from paddle_tpu_torch.models.gpt import GPTConfig
    cfg = GPTConfig(**cfg_kw)
    t0 = time.perf_counter()
    with RouteTap() as tap:
        res = hybrid_run(torch, cfg, kw, load_tree(root, cfg.num_layers),
                         gpt_ids(cfg.vocab_size, batch, seq, seed), steps,
                         probe)
    res["route0"] = tap.first
    res["wall_s"] = time.perf_counter() - t0
    return res


def gpt_case(torch, root, runs):
    """One rank of a hybrid_gpt, sp_gpt or moe_gpt world: each run
    (name, config kwargs, step kwargs, batch, seq[, steps]) in order."""
    return {name: gpt_run(torch, root, *args) for name, *args in runs}


def mesh_report(phase, what, name, ranks, ref, mesh, batch, seq, want,
                route="tc", rtol=(HYBRID_RTOL,), micro=1):
    """One line for a run of a hybrid_gpt / sp_gpt / moe_gpt world, then
    its gates: the same losses on every rank, finite, each within its
    step's `rtol` (one bound a step, the last repeating) of the single
    rank's (when `ref`), and each rank's launches of rows 2-5 and 8-9 exactly `want`,
    all on `route` (one name, or one a kernel). Under pp the line has
    the measured bubble (pp receive wait over the schedule) beside
    (S - 1) / (M + S - 1), M = `micro`. Returns the line and the gates'
    failures (the caller fails on them once it has printed what it
    adds)."""
    per = [r[name] for r in ranks]
    losses = per[0]["losses"]
    rel = None if ref is None else [
        abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    tol = [rtol[min(i, len(rtol) - 1)] for i in range(len(losses))]
    timed_steps = max(len(per[0]["times"]) - 1, 1)

    def med(key, got):
        return statistics.median(s.get(key, 0.0)
                                 for s in got["stats"][-timed_steps:])

    step_s = statistics.median(t for got in per
                               for t in got["times"][-timed_steps:])
    ref_s = statistics.median(ref["times"][1:]) if ref else None
    line = {"phase": phase, "run": what, "mesh": mesh, "batch": batch,
            "seq": seq, "losses": losses,
            "single_rank_losses": ref["losses"] if ref else None,
            "max_rel": max(rel) if rel else None,
            "rtol": tol,
            "step_ms_median": round(step_s * 1e3, 3),
            "single_rank_step_ms_median": round(ref_s * 1e3, 3)
            if ref else None,
            "tokens_per_s": round(batch * seq / step_s, 2),
            "single_rank_tokens_per_s": round(batch * seq / ref_s, 2)
            if ref else None,
            "peak_gb": [got["peak_gb"] for got in per],
            "single_rank_peak_gb": ref["peak_gb"] if ref else None,
            "load_s": [round(got["load_s"], 2) for got in per],
            # the tree read, the step built, the probe and the steps
            "run_wall_s": [round(got["wall_s"], 2) for got in per],
            "single_rank_wall_s": round(ref["wall_s"], 2) if ref
            else None,
            **{f"{k}_ms": [round(med(f"{k}_s", got) * 1e3, 3)
                           for got in per]
               for k in ("sp", "ep", "tp", "dp", "pp_send", "pp_recv")},
            "schedule_ms": [round(med("schedule_s", got) * 1e3, 3)
                            for got in per],
            "moment_bytes": [got["moment_bytes"] for got in per],
            "unsharded_moment_bytes": [got["unsharded_moment_bytes"]
                                       for got in per],
            "launches_predicted": want,
            "launches": [{k: v for k, v in got["counts"].items()
                          if k.split(".")[0] in want} for got in per]}
    S = mesh.get("pp", 1)
    if S > 1:
        line["bubble"] = [round(med("pp_recv_s", got)
                                / med("schedule_s", got), 4) for got in per]
        line["bubble_predicted"] = round((S - 1) / (micro + S - 1), 4)
    print(json.dumps(line), flush=True)
    bad = [f"rank {r} losses {got['losses']} against rank 0's {losses}"
           for r, got in enumerate(per) if got["losses"] != losses]
    if not all(math.isfinite(x) for x in losses):
        bad.append(f"non-finite losses {losses}")
    if rel is not None and not all(r <= t for r, t in zip(rel, tol)):
        bad.append(f"losses {losses} against the single rank's "
                   f"{ref['losses']} (rtol {tol})")
    routes = route if isinstance(route, dict) else {k: route for k in want}
    for r, got in enumerate(per):
        c = got["counts"]
        off = {k: (c.get(k, 0), c.get(f"{k}.{routes[k]}", 0), n)
               for k, n in want.items()
               if not c.get(k, 0) == c.get(f"{k}.{routes[k]}", 0) == n}
        if off:
            bad.append(f"rank {r} launches (all, on {routes}, expected) "
                       f"{off}")
    return line, [f"{phase} {what}: {b}" for b in bad]


def check(failures):
    if failures:
        fail("; ".join(failures))


def sp_a_prepare(torch, root, L):
    """(a) GPT-3 XL's first L layers (the tree under `root`) at sp 2
    against the single rank (attn_impl "xla") on the same weights and
    batch (module docstring, phase 17); world_phases' prepare (2 ranks).
    Its report returns each rank's launch counts, for the kernels
    line."""
    cfg_a = dict(XL, num_layers=L, **SP_CFG)
    ref_a = gpt_run(torch, root, dict(cfg_a, attn_impl="xla"), {},
                    SP_A_BATCH, SP_A_SEQ)

    def report(ranks):
        ranks_a = [r["a"] for r in ranks]
        check(mesh_report("sp_gpt", "a", "a", ranks_a, ref_a, SP_A,
                          SP_A_BATCH, SP_A_SEQ,
                          mesh_launches(L, kind="sp"))[1])
        return [rank["a"]["counts"] for rank in ranks_a]

    return [("a", "gpt", (root, [("a", cfg_a, SP_A, SP_A_BATCH, SP_A_SEQ,
                                  HYBRID_STEPS)]))], 600, report


def sp_b_prepare(torch, root):
    """(b) HYBRID_B_LAYERS at dp 2 x pp 2 x sp 2 under 1F1B against the
    single rank (attn_impl "xla"), then once at dropout 0.1 (module
    docstring, phase 17); world_phases' prepare (8 ranks)."""
    Lb = HYBRID_B_LAYERS
    cfg_b = dict(XL, num_layers=Lb, **SP_CFG)
    ref_b = gpt_run(torch, root, dict(cfg_b, attn_impl="xla"), {},
                    SP_B_BATCH, TRAIN_TOKENS)
    mesh_b = {k: v for k, v in SP_B.items() if k != "n_microbatches"}
    runs = [("b", cfg_b, SP_B, SP_B_BATCH, TRAIN_TOKENS, HYBRID_STEPS),
            ("dropout", dict(cfg_b, dropout=0.1), SP_B, SP_B_BATCH,
             TRAIN_TOKENS, 1)]

    def report(ranks):
        ranks_b = [r["b"] for r in ranks]
        M = SP_B["n_microbatches"]
        check(mesh_report("sp_gpt", "b 1F1B", "b", ranks_b, ref_b, mesh_b,
                          SP_B_BATCH, TRAIN_TOKENS,
                          mesh_launches(Lb, mesh_b["pp"], M, kind="sp"),
                          micro=M)[1])
        check(mesh_report("sp_gpt", "b dropout 0.1", "dropout", ranks_b,
                          None, mesh_b, SP_B_BATCH, TRAIN_TOKENS,
                          mesh_launches(Lb, mesh_b["pp"], M, steps=1,
                                        kind="sp"), micro=M)[1])

    return [("b", "gpt", (root, runs))], 600, report


def probe_errors(got, want):
    """The worst rank's relative error of hybrid_run's probe against the
    single rank's: the global norm, and each probed leaf in L2."""
    import numpy as np
    out = {"norm": max(abs(g["norm"] - want["norm"]) / want["norm"]
                       for g in got)}
    for n, w in want["grads"].items():
        out[n] = max(float(np.linalg.norm(g["grads"][n] - w)
                           / np.linalg.norm(w)) for g in got)
    return out


def moe_tree(seed):
    """The MoE weight tree of `seed` and the seconds it took to draw."""
    from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    t0 = time.perf_counter()
    tree = init_gpt_params(GPTConfig(**MOE_CFG), seed=seed)
    return tree, time.perf_counter() - t0


def moe_gpt_prepare(torch, seed=0, drawn=None):
    """GPT-2 small widths with 8 experts (MOE_CFG) at dp 2 x ep 2 x tp 2
    against the single rank on the same tree and batch (both drawn from
    `seed`; `drawn`: moe_tree(seed)'s result, drawn beforehand), in
    bf16 and again in f32 (module docstring, phase 18); world_phases'
    prepare (8 ranks). Its report returns each rank's launch counts of
    the bf16 run."""
    import atexit
    import shutil
    import numpy as np
    from paddle_tpu_torch.models.gpt import GPTConfig
    cfg = GPTConfig(**MOE_CFG)
    tree, init_s = drawn if drawn is not None else moe_tree(seed)
    del drawn
    root = tree_root(tree, "moe_tree")
    # the report removes it; this, if a phase fails first
    atexit.register(shutil.rmtree, root, True)
    bank = {k: tree["blocks"][k].nbytes for k in
            ("we_up", "be_up", "we_down", "be_down")}
    n_params = sum(v.size for v in tree.values() if hasattr(v, "size")) \
        + sum(v.size for v in tree["blocks"].values())
    del tree
    f32 = dict(MOE_CFG, amp_dtype=None)
    ref = gpt_run(torch, root, MOE_CFG, {}, MOE_BATCH, TRAIN_TOKENS,
                  seed=seed, probe=MOE_PROBE)
    ref32 = gpt_run(torch, root, f32, {}, MOE_BATCH, TRAIN_TOKENS,
                    seed=seed, probe=MOE_PROBE)
    runs = [(name, c, MOE_MESH, MOE_BATCH, TRAIN_TOKENS, HYBRID_STEPS,
             seed, MOE_PROBE)
            for name, c in (("moe", MOE_CFG), ("moe_f32", f32))]

    def report(ranks):
        shutil.rmtree(root, ignore_errors=True)
        ranks = [r["moe"] for r in ranks]
        want_launches = mesh_launches(cfg.num_layers, kind="moe")
        line, bad = mesh_report("moe_gpt", "dp2 x ep2 x tp2", "moe", ranks,
                                ref, MOE_MESH, MOE_BATCH, TRAIN_TOKENS,
                                want_launches, rtol=MOE_RTOL["bf16"])
        bad += mesh_report("moe_gpt", "dp2 x ep2 x tp2 f32", "moe_f32",
                           ranks, ref32, MOE_MESH, MOE_BATCH, TRAIN_TOKENS,
                           want_launches, route="simt",
                           rtol=MOE_RTOL["f32"])[1]
        probes = {}
        for what, name, want in (("bf16", "moe", ref),
                                 ("f32", "moe_f32", ref32)):
            probes[what] = probe_errors([r[name]["probe"] for r in ranks],
                                        want["probe"])
            tol = MOE_PROBE_RTOL[what]
            over = {k: v for k, v in probes[what].items() if not v <= tol[k]}
            if over:
                bad.append(f"moe_gpt {what} first-step gradients off the "
                           f"single rank's by {over} (relative, bound {tol})")
        ep, tp = MOE_MESH["ep"], MOE_MESH["tp"]
        split = ("we_up", "be_up", "we_down")
        want = sum(bank[k] for k in split)
        for r, rank in enumerate(ranks):
            got = sum(rank["moe"]["leaf_bytes"][f"blocks.{k}"] for k in split)
            if got * ep * tp != want:
                bad.append(f"moe_gpt rank {r}: expert bytes {got} not "
                           f"1/{ep * tp} of the bank's {want}")
        experts, kept = ref["route0"]
        n = experts.size // MOE_MESH["dp"]
        other = [float(np.mean(rank["moe"]["route0"][0] != experts[
            rank["moe"]["coords"]["dp"] * n:(rank["moe"]["coords"]["dp"] + 1)
            * n])) for rank in ranks]
        print(json.dumps({
            "phase": "moe_gpt", "run": "routing and memory",
            "config": "GPT-2 small widths, 8 experts top-1, capacity factor "
            "1.25, bf16, flash, remat", "seed": seed, "params": int(n_params),
            "init_s": round(init_s, 2),
            "layer0_routed_elsewhere": other,
            "layer0_dropped_single_rank": float(1.0 - kept.mean()),
            "layer0_dropped": [float(1.0 - rank["moe"]["route0"][1].mean())
                               for rank in ranks],
            "expert_bytes_split": [sum(rank["moe"]["leaf_bytes"][
                f"blocks.{k}"] for k in split) for rank in ranks],
            "expert_bytes_bank": want,
            "be_down_bytes": [rank["moe"]["leaf_bytes"]["blocks.be_down"]
                              for rank in ranks],
            "be_down_bank": bank["be_down"],
            "routes": [{k: v for k, v in rank["moe"]["counts"].items()
                        if k.startswith("flash")} for rank in ranks],
            "step_ms": line["step_ms_median"],
            # the first step's gradients (the same weights) against the
            # single rank's, relative, worst rank
            "first_step_grads_rel": probes,
            "first_step_grads_rtol": MOE_PROBE_RTOL,
            "single_rank_bf16_vs_f32_first_step_grads_rel": probe_errors(
                [ref["probe"]], ref32["probe"]),
            # bf16's own trajectory against f32's, on one rank and split
            "single_rank_bf16_vs_f32_max_rel": max(
                abs(a - b) / abs(b) for a, b in zip(ref["losses"],
                                                    ref32["losses"])),
            "split_bf16_vs_f32_max_rel": max(
                abs(a - b) / abs(b) for a, b in zip(
                    ranks[0]["moe"]["losses"],
                    ranks[0]["moe_f32"]["losses"]))}),
              flush=True)
        check(bad)
        return [rank["moe"]["counts"] for rank in ranks]

    return [("moe", "gpt", (root, runs))], 600, report


def moe_gpt_phase(torch, seed=0, drawn=None):
    """moe_gpt_prepare's phase in a world of its own; each rank's launch
    counts of the bf16 run."""
    return world_phases(math.prod(MOE_MESH.values()), [
        ("moe_gpt", moe_gpt_prepare, (torch, seed, drawn))])["moe_gpt"]


def widedeep_batch(cfg):
    """widedeep_phase's (bench_widedeep's) seeded batch."""
    import numpy as np
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (WD_BATCH, cfg.num_slots))
    dense = rng.randn(WD_BATCH, cfg.dense_dim).astype(np.float32)
    return ids, dense, (ids[:, 0] % 2).astype(np.float32)[:, None]


def widedeep_steps(torch, kw, steps):
    """`steps` steps of WideDeepTrainStep(WideDeepConfig(), **kw) on
    widedeep_batch: losses, each step's seconds and comm seconds, peak
    memory, this rank's and the whole tables' bytes."""
    from paddle_tpu_torch.models.wide_deep import (WideDeepConfig,
                                                   WideDeepTrainStep)
    cfg = WideDeepConfig()
    step = WideDeepTrainStep(cfg, **kw)
    batch = widedeep_batch(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, stats = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        stats.append(dict(step.last_stats))
    return {"losses": losses, "times": times, "stats": stats,
            "table_bytes": sum(step.local_params[k].numel() * 4
                               for k in ("embed", "wide")),
            "whole_table_bytes": cfg.vocab_size * (cfg.embed_dim + 1) * 4,
            "coords": {a: step.mesh.coord(a) for a in ("dp", "mp")},
            "peak_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}


def widedeep_mp_case(torch, steps):
    return widedeep_steps(torch, WD_MESH, steps)


def widedeep_mp_prepare(torch):
    """Phase 14's headline wide&deep at dp 2 x mp 2 against the single
    rank (module docstring, phase 19); world_phases' prepare."""
    ref = widedeep_steps(torch, dict(dp=1, mp=1), WD_MP_STEPS)
    gc.collect()
    torch.cuda.empty_cache()

    def report(ranks):
        ranks = [r["widedeep_mp"] for r in ranks]
        losses = ranks[0]["losses"]
        for r, rank in enumerate(ranks):
            if rank["losses"] != losses:
                fail(f"widedeep_mp rank {r} losses {rank['losses']} against "
                     f"rank 0's {losses}")
            if rank["table_bytes"] * WD_MESH["mp"] \
                    != rank["whole_table_bytes"]:
                fail(f"widedeep_mp rank {r}: table bytes "
                     f"{rank['table_bytes']} not 1/{WD_MESH['mp']} of "
                     f"{rank['whole_table_bytes']}")
        diff = [abs(a - b) for a, b in zip(losses, ref["losses"])]
        timed_s = statistics.median(t for rank in ranks
                                    for t in rank["times"][1:])
        print(json.dumps({
            "phase": "widedeep_mp", "mesh": WD_MESH, "batch": WD_BATCH,
            "steps": WD_MP_STEPS, "losses": losses,
            "single_rank_losses": ref["losses"], "max_abs_diff": max(diff),
            "atol": WD_MP_ATOL,
            "step_ms_median": round(timed_s * 1e3, 3),
            "examples_per_s": round(WD_BATCH / timed_s, 1),
            "single_rank_examples_per_s": round(WD_BATCH / statistics.median(
                ref["times"][1:]), 1),
            "phase14_examples_per_s": MEASURED.get("widedeep_examples_per_s"),
            "lookup_allreduce_ms": [round(statistics.median(
                s.get("mp_s", 0.0) for s in rank["stats"][1:]) * 1e3, 3)
                for rank in ranks],
            "dp_allreduce_ms": [round(statistics.median(
                s.get("dp_s", 0.0) for s in rank["stats"][1:]) * 1e3, 3)
                for rank in ranks],
            "table_bytes": [rank["table_bytes"] for rank in ranks],
            "whole_table_bytes": ranks[0]["whole_table_bytes"],
            "peak_gb": [rank["peak_gb"] for rank in ranks]}), flush=True)
        if not max(diff) <= WD_MP_ATOL or not all(
                math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            fail(f"widedeep_mp: losses {losses} against the single rank's "
                 f"{ref['losses']} (atol {WD_MP_ATOL}), or not falling")

    return [("widedeep_mp", "widedeep_mp", (WD_MP_STEPS,))], 300, report


# ---------------------------------------------------------------------------
# elastic training (item 16(c)): the launcher, gang restarts and the
# cluster checkpoint, BERT-base widths at dp 2 on the one card
# ---------------------------------------------------------------------------

# bench_elastic's drill at bench_bert's configuration cut to 4 layers (at
# 12 the phase took 170 s of a script past its time limit on one H100:
# five gang lives, each 17-20 s to its first step, 9.6 of them building
# the model): 8 steps a run, an
# async cluster save every 2, rank 1 killed (run b) or flapping (run c)
# at step 5; run (c)'s world-1 losses against the world-2 curve within
# bert_dp's bound. Run (c) saves every 4 instead: one version
# before the kill, the one its lives resume from (with a save every 2
# the step-2 version's write held up step 4's host copy and the last
# life ended waiting for step 6's write: time the whole script's clock
# cannot spare; run (b) measures the writes). Then bench_elastic's
# save-overhead measure as it is (a 512-wide tanh MLP, 120 steps, a save
# every 30).
ELASTIC_STEPS, ELASTIC_SAVE_EVERY, ELASTIC_KILL_AT = 8, 2, 5
ELASTIC_BERT_LAYERS = 4
ELASTIC_SHRINK_SAVE_EVERY = 4
ELASTIC_RTOL, ELASTIC_JOB_TIMEOUT = 1e-3, 420
ELASTIC_MLP, ELASTIC_MLP_STEPS, ELASTIC_MLP_EVERY = 512, 120, 30
ELASTIC_ROOT = os.path.dirname(os.path.abspath(__file__))
ELASTIC_TRAINER = os.path.join(ELASTIC_ROOT, "tests",
                               "torch_elastic_trainer.py")
# the route of each BERT row at a dp 2 rank's shapes (8 x 128 tokens):
# flash in bf16 on the tensor cores, the f32 sub-blocks on FFMA, layer
# norm (C = 768) on the warp route
ELASTIC_ROUTES = {"flash_fwd": "tc", "flash_bwd_dq": "tc",
                  "flash_bwd_dkv": "tc", "fused_out_ln": "ffma",
                  "fused_ffn_ln": "ffma", "layer_norm_fwd": "warp",
                  "layer_norm_bwd_dx": "warp"}


def elastic_job(work, tag, args=(), **knobs):
    """tests/torch_elastic_trainer.py in bert mode on the card under
    ``python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2``
    (gloo, both ranks on the one card), in a session of its own that is
    killed whole on the way out. Returns the launcher's exit code, its
    [launch] lines, every step record of both ranks (time order), the
    wall seconds and the final parameters' npz path."""
    import signal
    import socket
    base = os.path.join(work, tag)
    out, ckpt, logs = (os.path.join(base, d) for d in ("out", "ckpt",
                                                       "logs"))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = ELASTIC_ROOT + os.pathsep + env.get("PYTHONPATH",
                                                            "")
    drill = dict(ELASTIC_DRILL_OUT=out, ELASTIC_DRILL_MODEL="bert",
                 ELASTIC_DRILL_DEVICE="cuda", ELASTIC_DRILL_BERT_SIZE="base",
                 ELASTIC_DRILL_BERT_LAYERS=ELASTIC_BERT_LAYERS,
                 ELASTIC_DRILL_STEPS=ELASTIC_STEPS,
                 ELASTIC_DRILL_SAVE_EVERY=ELASTIC_SAVE_EVERY,
                 ELASTIC_DRILL_STEP_SLEEP=0)
    drill.update(knobs)
    env.update({k: str(v) for k, v in drill.items()})
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node=2", f"--started_port={port}", "--log_dir",
           logs, f"--cluster_ckpt_dir={ckpt}", *args, ELASTIC_TRAINER]
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, env=env, cwd=ELASTIC_ROOT,
                         stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        _, err = p.communicate(timeout=ELASTIC_JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        fail(f"elastic {tag}: the job outlived {ELASTIC_JOB_TIMEOUT} s; "
             f"{elastic_tails(logs)}")
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    wall = time.perf_counter() - t0
    recs, ends = [], []
    for r in (0, 1):
        for name, into in (("loss", recs), ("saves", ends)):
            path = os.path.join(out, f"{name}_rank{r}.jsonl")
            if os.path.exists(path):
                with open(path) as f:
                    into += [dict(json.loads(line), rank=r) for line in f]
    recs.sort(key=lambda r: r["t"])
    kills = []
    if os.path.exists(os.path.join(out, "kills.jsonl")):
        with open(os.path.join(out, "kills.jsonl")) as f:
            kills = [json.loads(line) for line in f]
    lines = [ln for ln in err.splitlines() if ln.startswith("[launch]")]
    return {"tag": tag, "rc": p.returncode, "launcher": lines,
            "records": recs, "ends": ends, "kills": kills, "t_end":
            time.time(), "wall_s": wall, "logs": logs,
            "final": os.path.join(out, "final_rank0.npz")}


def elastic_tails(logs, n=1500):
    if not os.path.isdir(logs):
        return "no logs"
    return " | ".join(f"{f}: {open(os.path.join(logs, f)).read()[-n:]}"
                      for f in sorted(os.listdir(logs)))


def elastic_curve(job, rank=0):
    """step -> record; the last record of a step wins (a killed life's
    tail is recomputed by the resumed one)."""
    return {r["step"]: r for r in job["records"] if r["rank"] == rank}


def elastic_lives(job):
    """The job's lives, one per (rank, pid), each its records in order,
    and the check of each: card, gloo where two ranks run, no kernel
    built in the child, and rows 2-5 and 8-9 launched
    bert_launches(ELASTIC_BERT_LAYERS) times a step of that life, all on
    the routes of ELASTIC_ROUTES."""
    lives: dict = {}
    for r in job["records"]:
        lives.setdefault((r["rank"], r["pid"]), []).append(r)
    out = []
    # pid order: the launcher starts rank 0 first, and a later life later
    for (rank, pid), recs in sorted(lives.items(), key=lambda kv: kv[0][1]):
        last, n = recs[-1], len(recs)
        counts = last["counts"]
        want = {k: v * n for k, v in
                bert_launches(ELASTIC_BERT_LAYERS).items()}
        off = {k: (counts.get(k, 0), counts.get(f"{k}.{ELASTIC_ROUTES[k]}",
                                                0), w)
               for k, w in want.items()
               if not counts.get(k, 0) == w
               == counts.get(f"{k}.{ELASTIC_ROUTES[k]}", 0)}
        backend = "gloo" if last["world"] == 2 else None
        life = {"rank": rank, "pid": pid, "world": last["world"],
                "steps": [recs[0]["step"], last["step"]],
                "resumed_from": last["resumed_from"],
                "restore_s": last["restore_s"],
                "upload_s": last["upload_s"],
                # process start -> the first step's record, less the step
                "start_s": round(recs[0]["since_start"]
                                 - recs[0]["step_s"], 3),
                # seconds from the process start to each setup stage
                "setup": {k: round(v, 3) for k, v in
                          (recs[0].get("setup") or {}).items()},
                "device": last["device"], "backend": last["backend"],
                "built_here": last["built_here"],
                "launches": {k: counts.get(k, 0) for k in want},
                "off_route": off}
        out.append(life)
        if not last["device"].startswith("cuda") \
                or last["backend"] != backend or last["built_here"] or off:
            fail(f"elastic {job['tag']}: rank {rank} life {pid}: device "
                 f"{last['device']}, backend {last['backend']} (want "
                 f"{backend}), kernels built in the child "
                 f"{last['built_here']}, launches (all, on the route, "
                 f"expected) off: {off}")
    return out


def elastic_row(job, ref=None):
    """The printed row of one job: the launcher's lines, its lives, the
    losses, step ms (a life's first step left out), detect -> resume (the
    largest gap between two step records, both ranks, as bench_elastic
    takes it), and rank 0's saves: host-copy seconds, the writer
    thread's part and merge seconds, the part's GB (from the step
    records and the end records of the lives that ran to the end)."""
    lives = elastic_lives(job)
    curve = elastic_curve(job)
    ts = [r["t"] for r in job["records"]]
    steady = [r["step_s"] for r in job["records"]
              if r["resumed_from"] is None and r["step"] > 0
              or r["resumed_from"] is not None
              and r["step"] > r["resumed_from"]]
    rank0 = [r for r in job["records"] + job["ends"] if r["rank"] == 0]
    saves = [s for r in rank0 for s in r["saves"]]
    writes = [w for r in rank0 for w in r["writes"]]
    seen, uniq = set(), []
    for x in saves + writes:
        key = json.dumps(x, sort_keys=True)
        if key not in seen:
            seen.add(key)
            uniq.append(x)
    parts = [w for w in uniq if w.get("kind") == "part"]
    merges = [w for w in uniq if w.get("kind") == "merge"]
    copies = [x["host_copy_s"] for x in uniq if "host_copy_s" in x]
    row = {"run": job["tag"], "rc": job["rc"],
           "wall_s": round(job["wall_s"], 2), "launcher": job["launcher"],
           "losses": [curve[s]["loss"] for s in sorted(curve)],
           "worlds": [curve[s]["world"] for s in sorted(curve)],
           "step_ms_median": round(statistics.median(steady) * 1e3, 3)
           if steady else None,
           "detect_resume_s": round(max(b - a for a, b in zip(ts, ts[1:])),
                                    3) if len(ts) > 1 else None,
           # the kill (after step 4's commit) -> the resumed life's first
           # step record
           "kill_to_resume_s": round(min(
               r["t"] for r in job["records"]
               if r["resumed_from"] is not None) - job["kills"][-1]["t"],
               3) if job["kills"] else None,
           "after_last_record_s": round(job["t_end"] - ts[-1], 3)
           if ts else None,
           "host_copy_s": [round(c, 4) for c in copies],
           "part_write_s": [w["seconds"] for w in parts],
           "merge_s": [w["seconds"] for w in merges],
           "ckpt_gb": max((w["bytes"] for w in parts), default=0) / 1e9,
           "lives": lives}
    if ref is not None:
        row["rel_to_ref"] = [abs(curve[s]["loss"] - ref[s]["loss"])
                             / abs(ref[s]["loss"]) for s in sorted(curve)]
    return row


def elastic_save_overhead(torch):
    """bench_elastic's cadence overhead on the card: the 512-wide tanh
    MLP step (float32, plain PyTorch), 120 steps, a ClusterCheckpoint
    save every 30, async then sync, between two runs without saves;
    the overhead against the faster of the two."""
    import shutil
    import tempfile

    import numpy as np
    from paddle_tpu_torch.distributed.cluster_ckpt import ClusterCheckpoint
    rs = np.random.RandomState(0)
    p0 = torch.tensor(rs.randn(ELASTIC_MLP, ELASTIC_MLP).astype("float32"),
                      device="cuda")
    x = torch.tensor(rs.randn(64, ELASTIC_MLP).astype("float32"),
                     device="cuda")

    def step(p):
        p = p.detach().requires_grad_()
        h = torch.tanh(torch.tanh(x @ p) @ p)
        g, = torch.autograd.grad(torch.sum(h * h), p)
        return (p - 1e-4 * g).detach()

    def run(async_save):
        p = step(p0)                          # warm
        torch.cuda.synchronize()
        root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
        ck = None if async_save is None else ClusterCheckpoint(
            root, rank=0, world=1, every_steps=ELASTIC_MLP_EVERY,
            async_save=async_save)
        try:
            t0 = time.perf_counter()
            for i in range(ELASTIC_MLP_STEPS):
                p = step(p)
                if ck is not None:
                    ck.maybe_save(i, replicated={"p": p})
            torch.cuda.synchronize()
            if ck is not None:
                ck.wait()
            return (time.perf_counter() - t0) / ELASTIC_MLP_STEPS
        finally:
            shutil.rmtree(root, ignore_errors=True)

    base1, t_async, t_sync, base2 = run(None), run(True), run(False), \
        run(None)
    base = min(base1, base2)
    return {"config": f"bench_elastic: tanh MLP {ELASTIC_MLP} wide, "
            f"{ELASTIC_MLP_STEPS} steps, save every {ELASTIC_MLP_EVERY}",
            "baseline_step_ms": [round(base1 * 1e3, 4),
                                 round(base2 * 1e3, 4)],
            "async_step_ms": round(t_async * 1e3, 4),
            "sync_step_ms": round(t_sync * 1e3, 4),
            "async_save_overhead_pct": round((t_async - base) / base * 100,
                                             2),
            "sync_save_overhead_pct": round((t_sync - base) / base * 100,
                                            2),
            "async_overhead_bar_pct": 5.0}


def elastic_phase(torch):
    """Phase 19b: BERT-base's widths at dp 2 through the port's
    launcher, killed, resumed bit for bit and shrunk to one rank
    (module docstring).
    Returns each rank's launches of run (a)."""
    import shutil
    import tempfile

    import numpy as np
    work = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        # (a) fault-free, dropout 0, without saves: the losses and
        # parameters are the same with them, and (b) measures them; the
        # reference of (b) (bit for bit) and of (c) (the world-2 curve).
        # At dropout 0 one fault-free run serves both drills: a second
        # one at dropout 0.1 cost a whole gang life of the clock (the
        # resume of the dropout seed is held bit for bit on the CPU,
        # tests/test_torch_elastic_bert.py)
        a = elastic_job(work, "a_fault_free", ELASTIC_DRILL_DROPOUT=0.0,
                        ELASTIC_DRILL_SAVE_EVERY=ELASTIC_STEPS + 1)
        if a["rc"] != 0:
            fail(f"elastic (a): launcher exit {a['rc']}: {a['launcher']} "
                 f"{elastic_tails(a['logs'])}")
        row_a = elastic_row(a)
        print(json.dumps({"phase": "elastic", **row_a}), flush=True)
        final_a = dict(np.load(a["final"]))
        # (b) rank 1 killed at step 5, a gang restart, the resume
        b = elastic_job(work, "b_kill_resume",
                        ("--max_restarts=2", "--restart_backoff=0.05"),
                        ELASTIC_DRILL_DROPOUT=0.0,
                        ELASTIC_DRILL_KILL_RANK=1,
                        ELASTIC_DRILL_KILL_AT=ELASTIC_KILL_AT)
        if b["rc"] != 0:
            fail(f"elastic (b): launcher exit {b['rc']}: {b['launcher']} "
                 f"{elastic_tails(b['logs'])}")
        ca, cb = elastic_curve(a), elastic_curve(b)
        row_b = elastic_row(b, ca)
        final_b = dict(np.load(b["final"]))
        same = sorted(final_a) == sorted(final_b) and all(
            np.array_equal(final_a[k], final_b[k]) for k in final_a)
        row_b["bit_equal_losses"] = sorted(ca) == sorted(cb) and all(
            ca[s]["loss"] == cb[s]["loss"] for s in ca)
        row_b["bit_equal_params"] = same
        row_b["restarted"] = any("elastic restart 1/2" in ln
                                 for ln in b["launcher"])
        # the armed kill waits for step 4's version to commit
        row_b["resumed_from"] = sorted(
            {r["resumed_from"] for r in b["records"]} - {None})
        print(json.dumps({"phase": "elastic", **row_b}), flush=True)
        if not (row_b["bit_equal_losses"] and same and row_b["restarted"]
                and len(row_b["lives"]) == 4
                and row_b["resumed_from"] == [ELASTIC_KILL_AT]):
            fail(f"elastic (b): losses {row_b['losses']} against (a) "
                 f"{row_a['losses']}, parameters bit-equal {same}, "
                 f"launcher {b['launcher']}, lives {len(row_b['lives'])}, "
                 f"resumed from {row_b['resumed_from']}")
        shutil.rmtree(os.path.join(work, "b_kill_resume", "ckpt"))
        # (c) rank 1 flapping at step 5, excluded at its first failure:
        # the job goes on at world 1, held to (a)'s world-2 curve
        c = elastic_job(work, "c_shrink",
                        ("--max_restarts=2", "--restart_backoff=0.05",
                         "--exclude_flapping", "--flap_threshold=1"),
                        ELASTIC_DRILL_DROPOUT=0.0,
                        ELASTIC_DRILL_FLAP_RANK=1,
                        ELASTIC_DRILL_KILL_AT=ELASTIC_KILL_AT,
                        ELASTIC_DRILL_SAVE_EVERY=ELASTIC_SHRINK_SAVE_EVERY)
        if c["rc"] != 0:
            fail(f"elastic (c): launcher exit {c['rc']}: {c['launcher']} "
                 f"{elastic_tails(c['logs'])}")
        cc = elastic_curve(c)
        row_c = elastic_row(c, ca)
        resumed = {r["resumed_from"] for r in c["records"]} - {None}
        row_c["resumed_from"] = sorted(resumed)
        tail = range(ELASTIC_KILL_AT, ELASTIC_STEPS)
        rel = max(row_c["rel_to_ref"][s] for s in tail)
        row_c["max_rel_steps_5_7"] = rel
        row_c["rtol"] = ELASTIC_RTOL
        row_c["excluded"] = any("excluding flapping rank trainer.1" in ln
                                for ln in c["launcher"])
        print(json.dumps({"phase": "elastic", **row_c}), flush=True)
        worlds_ok = resumed == {ELASTIC_KILL_AT} and all(
            cc[s]["world"] == (2 if s < ELASTIC_KILL_AT else 1) for s in cc)
        if not (rel <= ELASTIC_RTOL and row_c["excluded"] and worlds_ok
                and sorted(cc) == list(range(ELASTIC_STEPS))):
            fail(f"elastic (c): steps 5-7 off the world-2 curve by {rel} "
                 f"(rtol {ELASTIC_RTOL}), excluded {row_c['excluded']}, "
                 f"worlds {row_c['worlds']}, resumed from {resumed}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    over = elastic_save_overhead(torch)
    print(json.dumps({"phase": "elastic_save_overhead", **over}),
          flush=True)
    print(json.dumps({
        "phase": "elastic_summary", "detect_resume_s":
        row_b["detect_resume_s"],
        "kill_to_resume_s": [row_b["kill_to_resume_s"],
                             row_c["kill_to_resume_s"]],
        "start_s": [lf["start_s"] for row in (row_a, row_b, row_c)
                    for lf in row["lives"]],
        "restore_s": [
            lf["restore_s"] for lf in row_b["lives"] + row_c["lives"]
            if lf["restore_s"] is not None],
        "upload_s": [lf["upload_s"] for lf in row_b["lives"]
                     + row_c["lives"] if lf["upload_s"] is not None],
        "host_copy_s": row_b["host_copy_s"],
        "part_write_s": row_b["part_write_s"], "merge_s": row_b["merge_s"],
        "ckpt_gb": row_b["ckpt_gb"],
        "step_ms_median": row_a["step_ms_median"],
        "bert_dp_step_ms": MEASURED.get("bert_dp_step_ms"),
        "async_save_overhead_pct": over["async_save_overhead_pct"],
        "sync_save_overhead_pct": over["sync_save_overhead_pct"]}),
        flush=True)
    return [lf["launches"] for lf in row_a["lives"]]


DP_CASES = {"bert": dp_bert_case, "parity": dp_parity_case,
            "allreduce": dp_allreduce_case, "gpt": gpt_case,
            "widedeep_mp": widedeep_mp_case}


# ---------------------------------------------------------------------------
# the parameter-server tier (item 16(a)): shards on the host over localhost
# TCP, Downpour and heter wide&deep workers on the card
# ---------------------------------------------------------------------------

PS_STEPS, PS_WARMUP, PS_BATCH, PS_TIMEOUT = 8, 1, 4096, 240
PS_RTOL, PS_ATOL = 1e-4, 1e-6


def ps_close(got, ref) -> bool:
    import numpy as np
    return bool(np.allclose(np.asarray(got), np.asarray(ref),
                            rtol=PS_RTOL, atol=PS_ATOL))


def np_err(got, ref) -> float:
    import numpy as np
    return float(np.max(np.abs(np.asarray(got) - np.asarray(ref))))


def widedeep_ps_parity(torch, steps=20):
    """WideDeepConfig.tiny(), local-mode FleetWrapper (in-process tables
    on the native core), lr 0.1, seed 0: a DownpourWorker on the card and
    one on the CPU run the same `steps` batches; every loss and every
    table pulled back afterwards within PS_RTOL / PS_ATOL. Then one
    HeterDenseWorker step on the card against the same step on the CPU:
    loss, d_emb, d_wide and the updated parameters."""
    import numpy as np
    from paddle_tpu_torch.distributed.fleet import (DownpourWorker,
                                                    FleetWrapper,
                                                    HeterDenseWorker)
    from paddle_tpu_torch.distributed.fleet.ps_roles import (ctr_batches,
                                                             run_tables)
    from paddle_tpu_torch.models.wide_deep import WideDeepConfig
    cfg = WideDeepConfig.tiny()
    batches = ctr_batches(cfg, steps)
    runs, native = {}, []
    for dev in ("cuda", "cpu"):
        fw = FleetWrapper()
        w = DownpourWorker(fw, cfg, lr=0.1, device=dev)
        w.push_initial_dense()
        losses = [w.train_one_batch(*b) for b in batches]
        tables = run_tables(fw, w, cfg)
        native += [t._native is not None for t in fw._local.values()]
        runs[dev] = (losses, tables)
    (gl, gt), (cl, ct) = runs["cuda"], runs["cpu"]
    outside = sorted(k for k in gt if not ps_close(gt[k], ct[k]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    err = max(np_err(gt[k], ct[k]) for k in gt)

    rng = np.random.RandomState(1)
    B = 64
    args = (rng.randn(B, cfg.num_slots * cfg.embed_dim).astype(np.float32)
            * 0.01, rng.randn(B, 1).astype(np.float32) * 0.01,
            rng.randn(B, cfg.dense_dim).astype(np.float32),
            (rng.rand(B, 1) > 0.5).astype(np.float32))
    heter = {}
    for dev in ("cuda", "cpu"):
        dw = HeterDenseWorker(cfg, "127.0.0.1:0", lr=0.1, device=dev)
        try:
            loss, d_emb, d_wide = dw.step(*args)
            heter[dev] = (loss, d_emb, d_wide, dw.host_params())
        finally:
            dw.server_close()
    (gl2, ge, gw, gp), (cl2, ce, cw, cp) = heter["cuda"], heter["cpu"]
    pairs = [(ge, ce), (gw, cw), (gp["wide_dense"], cp["wide_dense"]),
             (gp["bias"], cp["bias"])] + [
        (a[k], b[k]) for a, b in zip(gp["mlp"], cp["mlp"]) for k in a]
    heter_ok = abs(gl2 - cl2) <= PS_ATOL + PS_RTOL * abs(cl2) \
        and all(ps_close(a, b) for a, b in pairs)
    print(json.dumps({
        "phase": "widedeep_ps_parity", "config": "tiny, local-mode "
        f"FleetWrapper, batch 64, lr 0.1, {steps} Downpour steps, card "
        "against CPU; one heter dense step", "rtol": PS_RTOL,
        "atol": PS_ATOL, "losses_cuda": gl, "losses_cpu": cl,
        "loss_max_rel": rel, "tables_max_abs_err": err,
        "tables_outside": outside, "native_tables": native,
        "heter_loss": [gl2, cl2],
        "heter_max_abs_err": max(np_err(a, b) for a, b in pairs),
        "heter_within": heter_ok}), flush=True)
    if not all(ps_close(a, b) for a, b in zip(gl, cl)) or outside \
            or not heter_ok:
        fail(f"PS workers: card and CPU differ: losses {gl} against "
             f"{cl}, tables outside {outside}, heter within {heter_ok}")
    if not native or not all(native):
        fail(f"PS tables not on the native core: {native}")


def ps_result(p, what) -> dict:
    """The last stdout line of a finished role as JSON."""
    try:
        out, err = p.communicate(timeout=PS_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"{what} outlived {PS_TIMEOUT} s")
    if p.returncode != 0:
        fail(f"{what} exited {p.returncode}: {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def ps_rate(outs) -> tuple[float, float]:
    """The workers' examples/s together: every example of their timed
    windows over the union of the windows (the first start to the last
    end; the workers met at a barrier before them), and the share of
    that union in which every worker's window was open."""
    start = min(o["window"][0] for o in outs)
    end = max(o["window"][1] for o in outs)
    both = min(o["window"][1] for o in outs) - max(o["window"][0]
                                                   for o in outs)
    total = sum(o["batch"] * o["steps"] for o in outs)
    return total / (end - start), max(both, 0.0) / (end - start)


def ps_tables(eps, names) -> list[dict]:
    """Each shard's table sizes, read over the wire."""
    from paddle_tpu_torch.distributed.fleet.runtime \
        .parameter_server_runtime import PSClient
    out = []
    for ep in eps:
        cl = PSClient([ep])
        try:
            out.append({n: cl.size(n) for n in names})
        finally:
            cl.close()
    return out


def widedeep_ps_run(mode: str | None):
    """bench.py's bench_widedeep_ps_tcp whole (the call bench_widedeep
    makes): 2 port PSServer processes and 2 DownpourWorker processes on
    the one card over localhost TCP, WideDeepConfig(), batch PS_BATCH of
    Zipf(1.3) ids, lr 0.05, PS_WARMUP + PS_STEPS steps; mode "boxps"
    runs the workers through the BoxPS cache (capacity 1 << 21, flush
    every 8). Gates: losses finite, wire bytes non-zero, 0 port kernel
    launches, every shard on its native core, workers on the card."""
    from paddle_tpu_torch.distributed.fleet import ps_roles
    eps = ps_roles.free_endpoints(2)
    job = dict(PS_ENDPOINTS=",".join(eps), WORKERS=2)
    procs = []
    try:
        t0, t_wall = time.perf_counter(), time.time()
        shards = [ps_roles.spawn(ROLE="server", MY_ENDPOINT=ep)
                  for ep in eps]
        procs += shards
        ready = [ps_roles.ready(p) for p in shards]
        shards_s = time.time() - t_wall
        workers = [ps_roles.spawn(ROLE="worker", WORKER_ID=w,
                                  STEPS=PS_STEPS, WARMUP=PS_WARMUP,
                                  BATCH=PS_BATCH, MODE=mode or "",
                                  FLUSH_EVERY=8, **job) for w in range(2)]
        procs += workers
        outs = [ps_result(p, f"PS worker {w}")
                for w, p in enumerate(workers)]
        wall = time.perf_counter() - t0
        names = ["embed", "wide", "wide_dense", "bias"] + [
            f"mlp{i}.{k}" for i in range(4) for k in ("w", "b")]
        sizes = ps_tables(eps, names)
    finally:
        ps_roles.stop(procs)
    rate, overlap = ps_rate(outs)
    detail = [{k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in o.items() if k not in ("batch", "window")}
              for o in outs]
    row = {
        "phase": "widedeep_ps", "mode": mode or "plain",
        "config": "bench_widedeep_ps_tcp: WideDeepConfig() (vocab "
        "1048576, 26 slots, embed 16, 13 dense, hidden 400-400-400), "
        "Zipf(1.3) ids, lr 0.05" + (", BoxPS capacity 1<<21 flush 8"
                                    if mode else ""),
        "servers": 2, "workers": 2, "batch": PS_BATCH,
        "warmup": PS_WARMUP, "steps": PS_STEPS, "wall_s": round(wall, 2),
        # where the wall goes: the shards' ready lines, then each
        # worker's timed window (start, end), from the first spawn
        "shards_ready_s": round(shards_s, 2),
        "windows_s": [[round(t - t_wall, 2) for t in o["window"]]
                      for o in outs],
        "examples_per_s": round(rate, 1),
        "windows_overlap_share": round(overlap, 4),
        "wire_mb_out_per_worker_step": round(statistics.mean(
            o["push_pull_mb_out"] / o["steps"] for o in outs), 4),
        "wire_mb_in_per_worker_step": round(statistics.mean(
            o["push_pull_mb_in"] / o["steps"] for o in outs), 4),
        "worker_detail": detail,
        "shards": [dict(endpoint=r["endpoint"], native=r["native"],
                        tables=s) for r, s in zip(ready, sizes)]}
    print(json.dumps(row), flush=True)
    losses = [v for o in outs for v in o["losses"]]
    launched = {k: v for o in outs for k, v in o["port_launches"].items()
                if v}
    if not all(math.isfinite(v) for v in losses):
        fail(f"widedeep_ps {row['mode']}: losses not finite: {losses}")
    if not all(o["push_pull_mb_out"] > 0 and o["push_pull_mb_in"] > 0
               for o in outs):
        fail(f"widedeep_ps {row['mode']}: no wire bytes")
    if launched:
        fail(f"widedeep_ps {row['mode']} launched port kernels: "
             f"{launched}")
    if not all(r["native"] for r in ready):
        fail(f"widedeep_ps {row['mode']}: a shard is off its native "
             f"core: {ready}")
    if not all(o["device"].startswith("cuda") for o in outs):
        fail(f"widedeep_ps {row['mode']}: a worker ran off the card: "
             f"{[o['device'] for o in outs]}")
    return row


def widedeep_ps_phase(torch):
    """widedeep_ps_run plain, then through the BoxPS cache."""
    return [widedeep_ps_run(None), widedeep_ps_run("boxps")]


def heter_ps_run(n_cpu: int) -> dict:
    """A HeterDenseWorker on the card (this process, WideDeepConfig(),
    lr 0.05) behind `n_cpu` HeterCpuWorker processes over one port
    PSServer process, batch PS_BATCH, PS_WARMUP + PS_STEPS steps each:
    examples/s (ps_rate), the dense step's ms on the card, the losses.
    The dense step's CUDA events lie on the one default stream that
    every handler thread shares, so with more than one CPU worker a
    span can hold another worker's step as well; with one it holds its
    own step alone. Gates: losses finite, 0 port kernel launches, the
    dense worker on the card."""
    from paddle_tpu_torch.distributed.fleet import HeterDenseWorker, ps_roles
    from paddle_tpu_torch.models.wide_deep import WideDeepConfig
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    ep, = ps_roles.free_endpoints(1)
    dw = HeterDenseWorker(WideDeepConfig(), "127.0.0.1:0", lr=0.05)
    dw.serve_in_thread()
    reset_launch_counts()
    procs = []
    try:
        shard = ps_roles.spawn(ROLE="server", MY_ENDPOINT=ep)
        procs.append(shard)
        ready = ps_roles.ready(shard)
        cpus = [ps_roles.spawn(ROLE="heter_cpu", WORKER_ID=w,
                               PS_ENDPOINTS=ep, WORKERS=n_cpu,
                               DENSE_ENDPOINT=dw.endpoint, STEPS=PS_STEPS,
                               WARMUP=PS_WARMUP, BATCH=PS_BATCH)
                for w in range(n_cpu)]
        procs += cpus
        outs = [ps_result(p, f"heter CPU worker {w}")
                for w, p in enumerate(cpus)]
    finally:
        ps_roles.stop(procs)
        dw.shutdown()
        dw.server_close()
    counts = {k: v for k, v in launch_counts().items() if v}
    steps = dw.step_seconds[n_cpu * PS_WARMUP:]
    rate, overlap = ps_rate(outs)
    row = {
        "phase": "heter_ps", "cpu_workers": n_cpu,
        "config": f"WideDeepConfig(), dense worker on the card, {n_cpu} "
        "CPU workers, 1 shard, lr 0.05", "batch": PS_BATCH,
        "warmup": PS_WARMUP, "steps": PS_STEPS,
        "examples_per_s": round(rate, 1),
        "windows_overlap_share": round(overlap, 4),
        "dense_step_ms_median": round(statistics.median(steps) * 1e3, 4),
        "dense_step_spans_may_hold_other_steps": n_cpu > 1,
        "dense_steps": len(dw.step_seconds), "shard_native":
        ready["native"], "losses": [o["losses"] for o in outs],
        "dense_losses": dw.losses, "port_launches": counts}
    print(json.dumps(row), flush=True)
    losses = [v for o in outs for v in o["losses"]] + dw.losses
    if not all(math.isfinite(v) for v in losses):
        fail(f"heter_ps: losses not finite: {losses}")
    if counts:
        fail(f"heter_ps launched port kernels: {counts}")
    if dw.device.type != "cuda":
        fail(f"heter_ps: the dense worker ran on {dw.device}")
    return row


def heter_ps_phase(torch):
    """heter_ps_run with one CPU worker (the dense step's ms alone on
    the card), then with two (the workers' examples/s together)."""
    return [heter_ps_run(1), heter_ps_run(2)]


def ps_runner(root: str):
    """One DownpourWorker process on the card for the runs of phases
    23-24 (ps_roles ROLE=runner): WideDeepConfig(), batch PS_BATCH,
    PS_WARMUP + PS_STEPS steps a run, the local step under
    torch.use_deterministic_algorithms with cuBLAS's deterministic
    workspace set before the process starts CUDA."""
    from paddle_tpu_torch.distributed.fleet import ps_roles
    return ps_roles.Runner(os.path.join(root, "runner.log"),
                           BATCH=PS_BATCH, WARMUP=PS_WARMUP,
                           STEPS=PS_STEPS)


def run_diff(a: dict, b: dict) -> float:
    """The largest absolute difference between two runs' losses and
    pulled-back tables (0.0: bit-equal)."""
    import numpy as np
    la, lb = np.asarray(a["line"]["losses"]), np.asarray(b["line"]["losses"])
    if la.shape != lb.shape or set(a["tables"]) != set(b["tables"]):
        return math.inf
    d = [float(np.max(np.abs(la - lb))) if la.size else 0.0]
    for k, v in a["tables"].items():
        w = b["tables"][k]
        if v.shape != w.shape:
            return math.inf
        if k == "ids":
            d.append(0.0 if np.array_equal(v, w) else math.inf)
        elif v.size:
            d.append(float(np.max(np.abs(v.astype(np.float64) - w))))
    return max(d)


def run_figures(r: dict) -> dict:
    line = r["line"]
    return {"examples_per_s": round(line["examples_per_sec"], 1),
            "pull_ms": round(line["pull_ms"], 4),
            "local_ms": round(line["local_ms"], 4),
            "push_ms": round(line["push_ms"], 4),
            "step_ms": round(line["step_ms"], 4)}


def check_run(what: str, r: dict):
    """Gates every PS runner run shares: losses finite, the worker on
    the card, no port kernel launched."""
    line = r["line"]
    launched = {k: v for k, v in line["port_launches"].items() if v}
    if not all(math.isfinite(v) for v in line["losses"]):
        fail(f"{what}: losses not finite: {line['losses']}")
    if not line["device"].startswith("cuda"):
        fail(f"{what}: the worker ran on {line['device']}")
    if launched:
        fail(f"{what} launched port kernels: {launched}")


def widedeep_ps_ha_phase(torch, runner, root) -> float:
    """Phase 23: the DownpourWorker on the card over 2 shard groups,
    each a WAL-on primary and one standby process (semi-sync, K = 1):
    two fault-free runs, one over async pairs, then a chaos run in
    which shard 0's primary dies after a commit and before its reply
    (PADDLE_PS_FAULT_KILL_AFTER: half as many requests as that primary
    received in the first fault-free run, the standby's replication
    calls and the status polls before the run included, the lag
    sampler's left out; the row gives the push it cut) and
    ps_ha.promote_best promotes its standby at epoch 2. Gates: the
    primary died and the standby took over, the chaos run's and the
    async run's losses and tables (every touched row of embed and wide,
    every dense table) bit-equal to the first fault-free run's, or
    within the spread between the two fault-free runs if that is not 0;
    workers on the card; 0 port launches. Returns that spread."""
    from paddle_tpu_torch.distributed.fleet import ps_roles
    from paddle_tpu_torch.distributed.fleet.runtime.fault_injection \
        import KILL_EXIT_CODE
    semi = ps_roles.ha_run(runner, root, "semisync")
    semi2 = ps_roles.ha_run(runner, root, "semisync_2")
    asyn = ps_roles.ha_run(runner, root, "async", semisync=0)
    chaos = ps_roles.ha_run(runner, root, "chaos",
                            kill_after=semi["requests"] // 2)
    spread = run_diff(semi, semi2)
    async_diff = run_diff(semi, asyn)
    diff = run_diff(semi, chaos)
    kill_t = chaos["kill_t"]
    after = [e for _, e in chaos["line"]["pushes"]
             if kill_t is not None and e > kill_t]
    pushes = len(chaos["line"]["pushes"])
    stby = chaos["standby_status"]
    lag = {r["line"]["tag"]: {
        "mean": round(statistics.mean(r["lag_rows"]), 4)
        if r["lag_rows"] else None,
        "max": max(r["lag_rows"]) if r["lag_rows"] else None,
        "samples": len(r["lag_rows"]), "drain_s": round(r["drain_s"], 6)}
        for r in (semi, semi2, asyn)}
    row = {
        "phase": "widedeep_ps_ha",
        "config": "WideDeepConfig() (vocab 1048576, 26 slots, embed 16, "
        "13 dense, hidden 400-400-400), batch 4096 Zipf(1.3) ids from "
        "RandomState(7), lr 0.05, 1 worker on the card, 2 shard groups "
        "of a WAL-on primary + 1 standby, native tables",
        "batch": PS_BATCH, "warmup": PS_WARMUP, "steps": PS_STEPS,
        "semisync_k": 1, "kill_after_requests": semi["requests"] // 2,
        "killed_in_push": [pushes - len(after) + 1, pushes],
        "shards_native": [r["native"] for r in semi["ready"]],
        "killed_exit_code": chaos["killed_code"],
        "promoted": chaos["promoted"], "standby_now": {
            k: stby.get(k) for k in ("role", "epoch", "applied_seq")},
        "failover_kill_to_first_push_s":
        round(min(after) - kill_t, 6) if after else None,
        "promote_s": round(chaos["promote_t"] - kill_t, 6)
        if chaos["promote_t"] else None,
        "client_failovers": chaos["line"]["failovers"],
        "client_redirects": chaos["line"]["redirects"],
        "lag_rows": lag,
        "push_ms_p50": {"semisync": round(statistics.median(
            semi["line"]["push_ms_each"]), 4),
            "async": round(statistics.median(
                asyn["line"]["push_ms_each"]), 4)},
        "semisync": run_figures(semi), "async": run_figures(asyn),
        "chaos": run_figures(chaos),
        "fault_free_spread": spread, "async_max_abs_diff": async_diff,
        "chaos_max_abs_diff": diff,
        "losses": semi["line"]["losses"]}
    print(json.dumps(row), flush=True)
    for r in (semi, semi2, asyn, chaos):
        check_run(f"widedeep_ps_ha {r['line']['tag']}", r)
    if chaos["killed_code"] != KILL_EXIT_CODE:
        fail(f"widedeep_ps_ha: shard 0's primary did not die by the "
             f"injected kill (exit {chaos['killed_code']})")
    want = chaos["groups"][0].split("|")[1]
    if chaos["promoted"] != want or stby.get("role") != "primary" \
            or stby.get("epoch") != 2:
        fail(f"widedeep_ps_ha: standby {want} was not promoted at epoch "
             f"2: {chaos['promoted']}, {stby}")
    if chaos["line"]["failovers"] < 1 or not after:
        fail("widedeep_ps_ha: the worker never failed over to the "
             "promoted standby")
    if spread:
        print(json.dumps({"phase": "widedeep_ps_ha_nondeterminism",
                          "fault_free_max_abs_diff": spread}), flush=True)
    if async_diff > spread:
        fail(f"widedeep_ps_ha: the async run differs from the fault-free "
             f"run by {async_diff} (two fault-free runs: {spread})")
    if diff > spread:
        fail(f"widedeep_ps_ha: the chaos run differs from the fault-free "
             f"run by {diff} (two fault-free runs: {spread})")
    return spread


def tiered_bench(vocab=1 << 26, dim=8, batch=256, train_steps=400,
                 serve_steps=400, warm_budget=256 * 1024, seed=0) -> dict:
    """bench.py's bench_tiered whole on the port: a WAL-on PSServer
    (in this process, on a thread) with every table tiered under a
    256 KiB warm budget, 400 train steps (pull + push) and 400 serving
    pulls of Zipf(1.2) ids over a 2^26-row vocab, dim 8, batch 256."""
    import shutil
    import tempfile

    import numpy as np
    from paddle_tpu_torch.distributed.fleet.runtime \
        .parameter_server_runtime import PSClient, PSServer
    root = tempfile.mkdtemp(prefix="chip_smoke_tiered_")
    rng = np.random.default_rng(seed)
    try:
        srv = PSServer("127.0.0.1:0", wal=True,
                       snapshot_dir=os.path.join(root, "snap"),
                       tier_warm_bytes=warm_budget,
                       tier_store_dir=os.path.join(root, "store"))
        srv.serve_in_thread()
        cl = PSClient([srv.endpoint])

        def ids_for():
            return (rng.zipf(1.2, batch).astype(np.int64) - 1) % vocab

        t0 = time.perf_counter()
        for _ in range(train_steps):
            ids = ids_for()
            v = cl.pull("emb", dim, ids)
            cl.push("emb", dim, ids, 0.01 * v)
        train_s = time.perf_counter() - t0
        train_faults = cl.cold_faults
        lats = []
        for _ in range(serve_steps):
            ids = ids_for()
            t1 = time.perf_counter()
            cl.pull("emb", dim, ids)
            lats.append(time.perf_counter() - t1)
        serve_faults = cl.cold_faults - train_faults
        t = srv.tables["emb"]
        t.drain()
        st = t.stats()
        warm_after = t.warm_resident_bytes()
        cl.close()
        srv.kill()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lats.sort()
    lookups = st["warm_hits"] + st["cold_faults"]
    return {"vocab_rows": vocab, "dim": dim, "batch": batch,
            "train_steps": train_steps, "serve_steps": serve_steps,
            "serve_pull_p50_ms": round(lats[len(lats) // 2] * 1e3, 4),
            "serve_pull_p99_ms": round(lats[min(int(len(lats) * 0.99),
                                                len(lats) - 1)] * 1e3, 4),
            "train_examples_per_s": round(train_steps * batch / train_s, 1),
            "warm_hit_rate": round(st["warm_hits"] / lookups, 4)
            if lookups else 0.0,
            "warm_rows": st["warm_rows"], "cold_rows": st["cold_rows"],
            "segments": st["segments"],
            "demoted_clean": st["demoted_clean"],
            "demoted_flush": st["demoted_flush"],
            "cold_read_errors": st["cold_read_errors"],
            "client_cold_faults_train": int(train_faults),
            "client_cold_faults_serve": int(serve_faults),
            "warm_budget_bytes": warm_budget,
            "warm_bytes_after_drain": warm_after}


def ps_tiered_phase(torch, runner, root, spread: float):
    """Phase 24: (a) tiered_bench (bench_tiered whole); gates: warm
    bytes within the budget after the drain, no failed cold read.
    (b) the DownpourWorker on the card over 2 shards (numpy tables: a
    tiered table draws its new rows as the all-warm one does only
    there), once all-warm and once with embed tiered under a warm
    budget of 1/8 of the embed bytes the all-warm run left on each
    shard; gates: losses and tables bit-equal (or within phase 23's
    fault-free spread, if that was not 0), cold faults and demotions
    > 0, no failed cold read, the worker on the card, 0 port launches."""
    from paddle_tpu_torch.distributed.fleet import ps_roles
    from paddle_tpu_torch.models.wide_deep import WideDeepConfig
    bench = tiered_bench()
    print(json.dumps(dict({"phase": "ps_tiered", "part": "bench_tiered"},
                          **bench)), flush=True)
    if bench["warm_bytes_after_drain"] > bench["warm_budget_bytes"]:
        fail(f"ps_tiered: {bench['warm_bytes_after_drain']} warm bytes "
             f"after the drain, over the {bench['warm_budget_bytes']} "
             "budget")
    if bench["cold_read_errors"]:
        fail(f"ps_tiered: {bench['cold_read_errors']} failed cold reads")
    row_bytes = WideDeepConfig().embed_dim * 4
    warm = ps_roles.tier_run(runner, root, "all_warm")
    budgets = [s["embed_rows"] * row_bytes // 8 for s in warm["shards"]]
    tiered = ps_roles.tier_run(runner, root, "tiered", budgets=budgets)
    diff = run_diff(warm, tiered)
    shards = tiered["shards"]
    row = {"phase": "ps_tiered", "part": "downpour",
           "config": "WideDeepConfig(), batch 4096 Zipf(1.3) ids, lr 0.05, "
           "1 worker on the card, 2 shards (numpy tables), embed tiered "
           "under 1/8 of its all-warm bytes a shard",
           "batch": PS_BATCH, "warmup": PS_WARMUP, "steps": PS_STEPS,
           "warm_budget_bytes": budgets,
           "embed_rows": [s["embed_rows"] for s in warm["shards"]],
           "all_warm": run_figures(warm), "tiered": dict(
               run_figures(tiered),
               client_cold_faults=tiered["line"]["cold_faults"]),
           "shards": shards, "max_abs_diff": diff,
           "held_to": spread}
    print(json.dumps(row), flush=True)
    for r in (warm, tiered):
        check_run(f"ps_tiered {r['line']['tag']}", r)
    if diff > spread:
        fail(f"ps_tiered: the tiered run differs from the all-warm run by "
             f"{diff} (two fault-free runs: {spread})")
    if not tiered["line"]["cold_faults"] or not sum(
            s["cold_faults"] for s in shards):
        fail(f"ps_tiered: the cold tier served no row: {shards}")
    if not sum(s["demoted_clean"] + s["demoted_flush"] for s in shards):
        fail(f"ps_tiered: no row was demoted: {shards}")
    if any(s["cold_read_errors"] for s in shards):
        fail(f"ps_tiered: failed cold reads: {shards}")
    return row


def ps_ha_tier_phases(torch):
    """Phases 23-24 on one runner process (its own CUDA context), every
    process killed and the scratch root removed in a finally."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_ps_ha_")
    runner = ps_runner(root)
    try:
        spread = timed("widedeep_ps_ha", widedeep_ps_ha_phase, torch,
                       runner, root)
        timed("ps_tiered", ps_tiered_phase, torch, runner, root, spread)
    finally:
        runner.close()
        shutil.rmtree(root, ignore_errors=True)


def profile_static(torch, exe, main, fetch, feed, what, steps=3):
    """Device-time breakdown of `steps` static steps."""
    profile_steps(torch, lambda: exe.run(main, feed=feed, fetch_list=fetch,
                                         return_numpy=False), steps, what,
                  top_n=12)


def design_of(name):
    """The routes (and their designs) of the kernel `name`."""
    if name.startswith("flash"):
        return FLASH_DESIGN
    if name.startswith("layer_norm"):
        return LN_DESIGN
    if name.startswith("dropout_add_ln"):
        return DAL_DESIGN
    if name == "paged_attention":
        return PAGED_DESIGN
    return FFN_DESIGN if name == "fused_ffn" else DESIGN


def route_counts(counts, name):
    """The launches of `name` on each of its routes in a path's counts."""
    return {r: counts.get(f"{name}.{r}", 0) for r in design_of(name)}


def kernel_entry(row, launches):
    ent = {"name": row["kernel"], "route": "cuda",
           "source": SOURCE[row["kernel"]],
           "replaces": REPLACES[row["kernel"]], "launches": launches,
           "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
           "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
           "bound_by": row["bound_by"], "library_ms": row["library_ms"],
           "shape": row["shape"]}
    if "call_ms" in row:    # one wrapper call, host time included
        ent["call_ms"] = row["call_ms"]
    for key in ("device_ms",           # device time a call, no host time
                "simt_device_ms",      # the SIMT kernel on misaligned
                "simt_max_abs_err",    # copies, and the library chain
                "library_device_ms",
                "row_ms",              # rows 6-9's block-a-row kernel
                "row_max_abs_err",     # (misaligned copies) beside warp
                "rerun_bit_equal",
                "dx_is_dres"):         # row 7 at p = 0: one gradient
        if key in row:
            ent[key] = row[key]
    if "route" in row:      # which of the kernel's designs ran
        ent["design"] = f"{row['route']}: " \
            f"{design_of(row['kernel'])[row['route']]}"
    if row["kernel"] == "paged_attention":
        ent["splits"] = row["splits"]
        ent["gather_err"] = row["gather_err"]  # from the gather version
    for key in ("tile_ms", "split_ms",     # every FFMA tile (pair) / split
                "grid_ms"):                # size / LN grid, beside the
        if key in row:                     # rule's pick
            ent[key] = row[key]
    if "differ" in row:     # share of elements != the plain version's
        ent["differ"] = row["differ"]
    return ent


def kernels_line(results, serve_counts, wide_counts, train_counts,
                 bert_counts, layer_counts, ffn_counts, wire_counts,
                 hybrid_counts, sp_counts, moe_counts, online_counts,
                 router_counts, static_bert_counts):
    """One entry per kernel at the shape of the path it serves, with
    that path's launch count: paged attention from the serving run
    (decode, f32 cache, the vector route), its scalar route from the
    d = 256 serving run nested under "wide_heads" (its other
    instantiations under "shapes"); the flash kernels and the sub-blocks
    from the GPT training run (bf16, M = 1024), the sub-blocks with their serving
    decode numbers (f32, M = 8, the stream launches) nested under
    "serving" and their prefill numbers (f32, M = 256, the FFMA
    launches) under "serving_prefill", and all five with their
    BERT-shape numbers and the BERT run's launches nested under "bert";
    each of these with its launches by route ("routes"); the layer-norm
    kernels from the BERT run (f32, R = 2048, with the run's launches by
    route; R = 304 and bf16 under "shapes"); the dropout + residual +
    layer norm kernels from the encoder-layer phase (f32, R = 2048,
    p = 0.1, with the phase's launches by route; R = 304, bf16 and p = 0
    under "shapes"); fused_ffn from the
    static FFN program (f32, gelu, M = 8192), its other shapes nested
    under "shapes" with launches null. Rows 1-3 also carry the wire
    serving run's launches by route under "wire_routes", the online
    phase's (two streams across two weight swaps) under
    "online_launches" and the router phase's (two replicas: failover,
    respawn and a rollout) under "router_launches". Rows 2-5 and
    8-9 carry under "hybrid" their numbers at the shapes of the hybrid
    GPT path (a tp = 2 rank at GPT-3 XL width) with rank 0's launches of
    the pp = 2 x tp = 2 1F1B run, every rank's ("rank_launches") and
    rank 0's by route. Rows 2-3 carry under "sp_gpt" their numbers at
    an sp_gpt (a) rank's shape with that run's launches, rows 4-5 under
    "moe_gpt" theirs at a moe_gpt rank's shape with its launches; every
    row of 2-5 and 8-9 lists each rank's launches in both runs
    ("sp_gpt_launches", "moe_gpt_launches"; 0 where the path does not
    run it)."""
    def row(name, *keys):
        return next(r for r in results if r["kernel"] == name
                    and all(k in r["shape"] for k in keys))

    def mesh_runs(ent, name, tags):
        for phase, counts in (("sp_gpt", sp_counts),
                              ("moe_gpt", moe_counts)):
            ent[f"{phase}_launches"] = [c.get(name, 0) for c in counts]
            if phase in tags:
                sub = kernel_entry(row(name, tags[phase]),
                                   counts[0].get(name, 0))
                sub["rank_launches"] = ent[f"{phase}_launches"]
                sub["routes"] = route_counts(counts[0], name)
                ent[phase] = sub

    paged = kernel_entry(row("paged_attention", "ctx<=2048", "cache=f32"),
                         serve_counts.get("paged_attention", 0))
    # the serving run's own short contexts: launches counted above
    paged["serving_mix"] = kernel_entry(
        row("paged_attention", "serving mix", "cache=f32"), None)
    paged["routes"] = route_counts(serve_counts, "paged_attention")
    paged["wire_routes"] = route_counts(wire_counts, "paged_attention")
    paged["online_launches"] = route_counts(online_counts,
                                            "paged_attention")
    paged["router_launches"] = route_counts(router_counts,
                                            "paged_attention")
    wide = row("paged_attention", "scalar", "q=f32 pools=f32 aligned")
    paged["wide_heads"] = kernel_entry(
        wide, wide_counts.get("paged_attention", 0))
    paged["wide_heads"]["routes"] = route_counts(wide_counts,
                                                 "paged_attention")
    paged["wide_heads"]["shapes"] = [
        kernel_entry(r, None) for r in results
        if r["kernel"] == "paged_attention" and "scalar" in r["shape"]
        and r is not wide]
    kernels = [paged]
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        ent = kernel_entry(row(name, "causal bf16"),
                           train_counts.get(name, 0))
        ent["routes"] = route_counts(train_counts, name)
        ent["bert"] = kernel_entry(row(name, "bf16", "no mask (BERT)"),
                                   bert_counts.get(name, 0))
        ent["bert"]["routes"] = route_counts(bert_counts, name)
        ent["hybrid"] = kernel_entry(row(name, "(hybrid)"),
                                     hybrid_counts[0].get(name, 0))
        ent["hybrid"]["rank_launches"] = [c.get(name, 0)
                                          for c in hybrid_counts]
        ent["hybrid"]["routes"] = route_counts(hybrid_counts[0], name)
        mesh_runs(ent, name, {"moe_gpt": "(moe)"})
        kernels.append(ent)
    for name in ("fused_out_ln", "fused_ffn_ln"):
        ent = kernel_entry(row(name, f"M={TRAIN_TOKENS} ", "bf16"),
                           train_counts.get(name, 0))
        ent["routes"] = route_counts(train_counts, name)
        # the serving run: decode (and the short prefills) on stream, the
        # prefill buckets of 128 rows and more on FFMA
        ent["serving"] = kernel_entry(row(name, "M=8 "),
                                      serve_counts.get(f"{name}.stream", 0))
        ent["serving_prefill"] = kernel_entry(
            row(name, "M=256 "), serve_counts.get(f"{name}.ffma", 0))
        ent["serving_routes"] = route_counts(serve_counts, name)
        ent["wire_routes"] = route_counts(wire_counts, name)
        ent["online_launches"] = route_counts(online_counts, name)
        ent["router_launches"] = route_counts(router_counts, name)
        ent["bert"] = kernel_entry(row(name, "f32", "(BERT"),
                                   bert_counts.get(name, 0))
        ent["bert"]["routes"] = route_counts(bert_counts, name)
        ent["hybrid"] = kernel_entry(row(name, "(hybrid)"),
                                     hybrid_counts[0].get(name, 0))
        ent["hybrid"]["rank_launches"] = [c.get(name, 0)
                                          for c in hybrid_counts]
        ent["hybrid"]["routes"] = route_counts(hybrid_counts[0], name)
        mesh_runs(ent, name, {"sp_gpt": "(sp)"})
        kernels.append(ent)
    for name in ("layer_norm_fwd", "layer_norm_bwd_dx"):
        top = row(name, "R=2048", "f32")
        ent = kernel_entry(top, bert_counts.get(name, 0))
        ent["routes"] = route_counts(bert_counts, name)
        # the MLM head's 304 rows and bf16: launches counted with R=2048
        ent["shapes"] = [kernel_entry(r, None) for r in results
                         if r["kernel"] == name and r is not top
                         and "(hybrid)" not in r["shape"]]
        ent["hybrid"] = kernel_entry(row(name, "(hybrid)"),
                                     hybrid_counts[0].get(name, 0))
        ent["hybrid"]["rank_launches"] = [c.get(name, 0)
                                          for c in hybrid_counts]
        ent["hybrid"]["routes"] = route_counts(hybrid_counts[0], name)
        mesh_runs(ent, name, {})
        kernels.append(ent)
    for name in ("dropout_add_ln_fwd", "dropout_add_ln_bwd"):
        top = row(name, "R=2048", "f32", "p=0.1")
        ent = kernel_entry(top, layer_counts.get(name, 0))
        ent["routes"] = route_counts(layer_counts, name)
        # R = 304, bf16 and p = 0: launches counted with the layer's shape
        ent["shapes"] = [kernel_entry(r, None) for r in results
                         if r["kernel"] == name and r is not top]
        kernels.append(ent)
    main = f"M={FFN_M} H={FFN_H} I={FFN_I} f32 gelu"
    ent = kernel_entry(row("fused_ffn", main), ffn_counts.get("fused_ffn", 0))
    ent["routes"] = route_counts(ffn_counts, "fused_ffn")
    # no path runs the other shapes: their launches were not counted
    ent["shapes"] = [kernel_entry(r, None) for r in results
                     if r["kernel"] == "fused_ffn" and r["shape"] != main]
    kernels.append(ent)
    # rows 1-9 as the static BERT phase launched them (its BERT-base run,
    # its act-dropout program and the paged_attention op), by route
    for ent in kernels:
        if ent["name"] != "fused_ffn":
            ent["static_bert_launches"] = route_counts(static_bert_counts,
                                                       ent["name"])
    return {"kernels": kernels}


def ps_phases(torch):
    """Phases 20-24: the parameter-server tier."""
    timed("widedeep_ps_parity", widedeep_ps_parity, torch)
    gc.collect()
    torch.cuda.empty_cache()
    timed("widedeep_ps", widedeep_ps_phase, torch)
    timed("heter_ps", heter_ps_phase, torch)
    gc.collect()
    torch.cuda.empty_cache()
    ps_ha_tier_phases(torch)


def main(argv):
    if "--help" in argv or "-h" in argv:
        print(__doc__)
        return
    t_script = time.perf_counter()
    kernels_only = "--kernels" in argv
    ps_only = "--ps" in argv
    elastic_only = "--elastic" in argv
    online_only = "--online" in argv
    router_only = "--router" in argv
    read_parts_only = "--read-parts" in argv
    ops_only = "--ops" in argv
    seq_only = "--seq" in argv
    with_profile = "--profile" in argv
    moe_seed = int(argv[argv.index("--moe-seed") + 1]) \
        if "--moe-seed" in argv else None
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card (torch.cuda.is_available() is False)")
    try:
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"paddle_tpu_torch is not importable next to this script: {e}")
    from paddle_tpu_torch.models.gpt import (GPTConfig, disable_tf32,
                                             init_gpt_params)
    disable_tf32()
    card = card_line()
    print(card, flush=True)
    print(json.dumps({"phase": "versions", "python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    if seq_only:
        # no kernel lies on the LAC path: nothing to build first
        timed("static_lac", static_lac_phase, torch)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if ps_only:
        # no kernel lies on the PS path: nothing to build first
        ps_phases(torch)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    weights = None
    if not (kernels_only or elastic_only or online_only or router_only
            or read_parts_only or ops_only or moe_seed is not None):
        # the GPT-3 XL tree (seeded numpy on one core: most of a minute),
        # then moe_gpt's (a third of one), are drawn while nvcc builds
        # the kernels and the kernel checks run: numpy's generator and
        # casts release the GIL
        from concurrent.futures import ThreadPoolExecutor

        def draw():
            t = time.perf_counter()
            return (init_gpt_params(GPTConfig.gpt3_1p3b(), seed=0),
                    time.perf_counter() - t)

        drawer = ThreadPoolExecutor(1)
        weights = drawer.submit(draw)
        moe_weights = drawer.submit(moe_tree, 0)
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(json.dumps({"phase": "build", "seconds": round(
        time.perf_counter() - t0, 2), "per_source": secs}), flush=True)
    for name, log in _build.build_log().items():
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "wgmma")):
                print(f"ptxas {name}: {line.strip()}", file=sys.stderr)

    if elastic_only:
        timed("elastic", elastic_phase, torch)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    if online_only:
        online_alone(torch)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    if ops_only:
        timed("static_bert", static_bert_phase, torch)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    if router_only or read_parts_only:
        if router_only:
            check_two_threads(torch)
            router_alone(torch)
        if read_parts_only:
            timed("read_parts", read_parts_phase, torch)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    if moe_seed is not None:
        moe_gpt_phase(torch, moe_seed)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    t0 = time.perf_counter()
    timer = Timer(torch)
    results = []
    check_paged(torch, timer, results)
    check_paged_scalar(torch, timer, results)
    check_blocks(torch, timer, results)
    check_two_threads(torch)
    check_blocks_bf16(torch, timer, results)
    check_flash(torch, timer, results)
    check_rows(torch, timer, results)
    check_blocks_bert(torch, timer, results)
    check_flash_bert(torch, timer, results)
    check_flash_block_override(torch)
    check_ffn(torch, timer, results)
    check_hybrid_kernels(torch, timer, results)
    check_mesh_kernels(torch, timer, results)
    print(json.dumps({"phase": "seconds", "of": "kernel_checks",
                      "seconds": round(time.perf_counter() - t0, 2)}),
          flush=True)
    del timer
    torch.cuda.empty_cache()
    if kernels_only:
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    t0 = time.perf_counter()
    tree, init_s = weights.result()
    print(json.dumps({"phase": "weights", "config": "gpt3_1p3b", "seed": 0,
                      "init_s": round(init_s, 2),
                      "waited_s": round(time.perf_counter() - t0, 2)}),
          flush=True)
    serve_counts, eng, tokens, inproc = timed("serving_path", serving_path,
                                              torch, tree)
    import shutil
    ckpt_root = timed("checkpoint_phase", checkpoint_phase, torch, eng,
                      tokens, True)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        wire_counts = timed("wire_serving", wire_serving_phase, torch, eng,
                            tokens, inproc)
        gc.collect()
        slo_rate, slo_base, slo_wire = timed("slo", slo_phase, torch, eng)
        gc.collect()
        timed("chaos", chaos_phase, torch, eng, slo_rate, slo_base)
        del slo_base
        gc.collect()
        online_counts = timed("online", online_phase, torch, eng,
                              tokens[0], ckpt_root)
        gc.collect()
        torch.cuda.empty_cache()
        router_counts = timed("router", router_phase, torch, eng, ckpt_root,
                              slo_rate, slo_wire,
                              (eng.stats()["model_version"], 1))
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    if with_profile:
        profile_decode(torch, eng, eng.model.cfg.vocab_size)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    wide_counts = timed("serving_wide_heads", serving_wide_heads_phase,
                        torch)
    gc.collect()
    torch.cuda.empty_cache()

    timed("train_parity", train_parity, torch, tree)
    train_counts, step, ids = timed("training_path", training_path, torch,
                                    tree)
    if with_profile:
        profile_steps(torch, lambda: step(ids), 1, "train_step", top_n=16)
    del step
    gc.collect()
    torch.cuda.empty_cache()

    timed("bert_parity", bert_parity, torch)
    bert_counts, bstep, bbatch = timed("bert_training_path",
                                       bert_training_path, torch)
    if with_profile:
        profile_steps(torch, lambda: bstep(*bbatch), 1, "bert_train_step",
                      top_n=24)
    del bstep, bbatch
    gc.collect()
    torch.cuda.empty_cache()
    layer_counts = timed("encoder_layer", encoder_layer_phase, torch)
    gc.collect()
    torch.cuda.empty_cache()

    timed("static_lenet", static_lenet_phase, torch, with_profile)
    ffn_counts = timed("static_ffn", static_ffn_phase, torch, with_profile)
    gc.collect()
    torch.cuda.empty_cache()
    static_bert_counts = timed("static_bert", static_bert_phase, torch)
    gc.collect()
    torch.cuda.empty_cache()
    timed("static_lac", static_lac_phase, torch)
    gc.collect()
    torch.cuda.empty_cache()

    timed("resnet_parity", resnet_parity, torch)
    gc.collect()
    torch.cuda.empty_cache()
    timed("resnet50_phase", resnet50_phase, torch, with_profile)
    gc.collect()
    torch.cuda.empty_cache()

    timed("widedeep_parity", widedeep_parity, torch)
    timed("widedeep_phase", widedeep_phase, torch, with_profile)
    gc.collect()
    torch.cuda.empty_cache()
    L = min(MESH_A_LAYERS, tree["blocks"]["wq"].shape[0])
    root = tree_root(tree, "hybrid_tree")
    del tree
    gc.collect()
    try:
        # the phases that need a world of ranks on the card, one world a
        # size: a rank's start and first steps are paid once a world
        got = world_phases(DP_RANKS, [
            ("bert_dp", bert_dp_prepare,
             (torch, MEASURED.get("bert_samples_per_s"))),
            ("dp_parity", dp_parity_prepare, (torch,)),
            ("allreduce", allreduce_prepare, (torch,)),
            ("sp_gpt_a", sp_a_prepare, (torch, root, L))])
        dp_counts, sp_counts = got["bert_dp"], got["sp_gpt_a"]
        gc.collect()
        torch.cuda.empty_cache()
        assert math.prod(HYBRID_A.values()) == math.prod(WD_MESH.values())
        got = world_phases(math.prod(HYBRID_A.values()), [
            ("hybrid_gpt_a", hybrid_a_prepare, (torch, root, L)),
            ("widedeep_mp", widedeep_mp_prepare, (torch,))])
        hybrid_counts = got["hybrid_gpt_a"]
        gc.collect()
        torch.cuda.empty_cache()
        assert math.prod(HYBRID_B.values()) == math.prod(
            v for k, v in SP_B.items() if k != "n_microbatches") \
            == math.prod(MOE_MESH.values())
        got = world_phases(math.prod(HYBRID_B.values()), [
            ("hybrid_gpt_b", hybrid_b_prepare, (torch, root)),
            ("sp_gpt_b", sp_b_prepare, (torch, root)),
            ("moe_gpt", moe_gpt_prepare, (torch, 0, moe_weights.result()))])
        moe_counts = got["moe_gpt"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    drawer.shutdown()
    del moe_weights, got
    gc.collect()
    torch.cuda.empty_cache()
    elastic_counts = timed("elastic", elastic_phase, torch)
    gc.collect()
    torch.cuda.empty_cache()
    ps_phases(torch)

    print(json.dumps({"phase": "seconds", "of": "script", "seconds": round(
        time.perf_counter() - t_script, 2)}), flush=True)
    line = kernels_line(results, serve_counts, wide_counts, train_counts,
                        bert_counts, layer_counts, ffn_counts, wire_counts,
                        hybrid_counts, sp_counts, moe_counts, online_counts,
                        router_counts, static_bert_counts)
    for ent in line["kernels"]:
        if ent["name"] in BERT_LAUNCHES_PER_STEP:
            # the bert_dp run's launches, rank by rank, and those of
            # the elastic phase's fault-free run
            ent["bert_dp_launches"] = [c[ent["name"]] for c in dp_counts]
            ent["elastic_launches"] = [c[ent["name"]]
                                       for c in elastic_counts]
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
