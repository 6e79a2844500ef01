"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result):

1. device  — name and power limit, torch's CUDA and the NVIDIA driver
             version; TF32 off for matmuls and cuDNN, so fp32 means fp32
             in every comparison below.
2. build   — every kernel under paddle_tpu_torch/csrc, one nvcc each,
             all started together; registers, shared memory and spills
             of every kernel as ptxas reports them; then cuobjdump -sass
             must show HGMMA (wgmma) in each of the six bf16 tensor-core
             attention instantiations, in each of the twelve bf16
             short-attention ones (forward, dK/dV and dQ; D = 64 and 128;
             causal or not) and in each of the four grouped expert FFN
             GEMMs (GEMM 1 and GEMM 2, bf16 and int8 weights), and
             UBLKCP (cp.async.bulk, the page copies) in each of the 55
             paged-decode split-kernel instantiations (bf16 and int8
             pools, D = 64, 128, 256, q-row tiles of 1 to 8); HGMMA in
             the int8-weight matmul's prefill GEMM and HMMA in its four
             decode GEMV instantiations, with no I2F in either.
3. kernels — each kernel against its plain PyTorch version on the same
             CUDA tensors, at the shapes the serving and training paths
             give it, then its time (CUDA events, L2 flushed before each
             launch) beside its bound, the plain version's time and one
             library call's.  Paged decode also at the shapes its first
             kernel refused (G = 8 at an 8192-token window, MQA G = 32,
             D = 256), with 128-token pages (streamed in tiles), at
             lengths on, one past and inside the 256-token split
             boundary and 0, and timed at phase 4b's decode step (B = 8,
             every length 522) too; Llama-2-13B's 40 kv heads at ragged
             lengths in a 1024-token window, and timed at 4i's decode
             step (every length 543) beside its bound, plain version and
             library call.  3b holds attention at [4, 32, 2048,
             128] bf16 causal, at S=1024, in fp32, with fused RoPE, with
             GQA 32/8 at S=4096, not causal, and at S=4096, and times it
             at the training shape and in the flash region (S=4096
             causal, with and without GQA 32/8; SDPA with enable_gqa
             beside it).
3c. quant kernels — the int8-weight matmul at every Llama-2-7B and
             Llama-2-13B projection shape for M = 8 (decode) and M = 512
             (prefill),
             bf16 and f32 x, at gate/up also M = 1, 3, 9, 16, 32, 33, 64
             and 188 (bf16), with NaN in x's rows past M and garbage past K
             and N in the same allocations, and off the TMA shape rule
             (the SIMT kernels); each call must take its route, match
             the plain version and give the same bits twice.  Then
             paged decode over int8 pages at the decode shapes of 3 and
             its new shapes (13B's included), each against its plain
             version; timed as in 3 (the matmul at all twelve shape and
             M pairs, with its route; paged decode also at 4i's step).
3e. short kernels — short-sequence attention forward (out, its fp32
             copy, lse) and backward against the plain version at the
             BERT-base shape [48, 12, 384, 64] bf16 with p = 0.1 and 0,
             [4, 12, 384, 64] fp32, Llama's [4, 32, 512, 128] bf16 causal
             and the edges S = 1024 and S = 128; then the dropout mask
             itself (S = D = 128, p = 0.5, v = I and g = I: the zero
             patterns of out and dv equal the plain version's exactly);
             timed at the BERT shape beside the bound, the plain version
             and SDPA with dropout, and the BERT shape's times at p = 0.1
             beside p = 0 (the cost of the mask).
3v. verify kernels — paged decode (bf16 and int8 pools) at
             serve.verify's shape: batch 8, window 5, 40 query rows, each
             table row repeated 5 times, lengths 523 + w, against its
             plain version, timed beside two bounds (each sequence's pages
             read once, and read 5 times, as the kernel does) and SDPA
             with 5 query rows a sequence; the int8-weight matmul at
             verify's M = 40 on the gate/up shape beside its bound and
             torch.matmul.
4. serve   — Llama-2-7B at full width and depth in bf16, random weights
             from seed 0 made on the card, 8 seeded requests through
             ServingEngine (8 slots, 16-token pages, 2048-token window,
             512-token prefill chunks), served twice: decode eager (the
             forward launched op by op, the A/B baseline) and decode as
             replayed CUDA graphs (the port's path; one graph per batch
             size, captured at its first step).  Every request must
             finish, the kernel must have run once per layer per decode
             step (replays counted by each graph's capture tally), and
             the two runs must give identical greedy streams and KV pools
             bit for bit; TTFT / TPOT p50 and p99 of both, the graphs
             captured, the replays and the capture seconds.  4b profiles
             decode steps of each with torch.profiler.
4c. int8 serve — the same model and load, both ways, with
             quant="int8": every request finishes, paged_decode_quant
             launches once per layer per decode step, quant_matmul 7
             times per layer per forward (decode steps + prefill
             forwards), the bf16 paged_decode never; the matmul's calls by
             route; 4d profiles its decode steps both ways, quant_matmul's
             device ms apart from cuBLAS's.
4e. aot    — engines with aot="warm" and aot="strict" at phase 4's shape
             (every decode batch and decode_n at n = 8 captured at
             build): no failed warmup entry, phase 4's streams from both
             equal to an engine with the same prefill ladder and decode
             eager (whose warmup arms the ladder and captures nothing),
             AotMissError at a rung with no graph after seal(), and
             decode_n(8) at batch 8 equal to 8 decode steps, each timed.
             (Its control leg, an aot="off" engine at half the chunk
             whose streams were reported, not gated, was cut for time.)
4f. features — Llama-2-7B at full width and depth, phase 4's engine,
             the page pool's invariants checked after every step of every
             leg: (a) the prefix cache on vs off on 8 requests of 128-512
             tokens, 60% behind one of two 512-token prefixes, bf16 and
             int8, and on a 160-page pool where the tree must evict; (b)
             n-gram speculative decode (k = 4) vs off on prompts 75%
             tiled from 4 tokens, bf16 and int8, paged decode and
             quant_matmul counted under serve.verify replays, decode and
             verify steps profiled; (c) async vs sync on phase 4's load:
             async alone must give phase 4's streams, async with spec the
             sync spec engine's (both aot="strict": no failed warmup
             entry, no capture after seal()).  Hit rate, cow_count,
             evictions, tokens per decode step, acceptance, TTFT / TPOT,
             host_overlap_ratio and replans per leg; prefix and spec
             agreement with off is reported, not gated (bf16).
4g. durable serving — Llama-2-7B at full width and depth in bf16, phase
             4's engine shape and load, as a ServingCluster of 2 replicas
             sharing the weights: the journal off, then on (streams
             equal; records, fsyncs, their seconds and write_s over the
             serving wall, the journal's tax measured in the run); a child
             process (python -m paddle_tpu_torch.testing.durability_worker)
             serving the load into a journal and killed by an armed
             serve.step crash (exit 53), then ServingCluster.recover in
             this process (replay and rebuild seconds, ticks and seconds
             to the first recovered token); in process a replica crash
             (recompute failover) and a hang (its pages salvaged); an
             int8 fleet stopped mid-load and recovered.  Gated: every
             request finishes once with its max_new_tokens tokens, streams
             served from the journal and journaled prefixes equal the
             uninterrupted run's, the pools' invariants hold after every
             step, and the recovered fleets launch paged_decode (int8:
             paged_decode_quant and quant_matmul).  Tokens after a resume
             point are reported, not gated (bf16 recompute re-prefills
             at other GEMM shapes).
4h. elastic fleet — Llama-2-7B at full width and depth in bf16 on 4g's
             weights (not built again), phase 4's engine shape and load:
             (a) two mixed replicas of 2 slots take 6 requests at once,
             r0 is drained after three ticks (its queue re-steered), a
             replica joins and takes the last 2; every request
             finishes, r0 ends drained and idle,
             the pools' invariants hold after every step; the joined
             replica's graphs captured and their seconds; (b) a
             disaggregated fleet (one prefill and one decode replica):
             handoffs happen, the decode replica admits nothing and
             decodes, each handed-off sequence's K/V lands with the
             source's crc32, the handoffs' tokens, pages, and the ms and
             GB/s of each gather_dense + write_at, paged_decode launched;
             (c) the same with quant="int8": paged_decode_quant and
             quant_matmul launched.  Streams against 4g's are reported,
             not gated (the decode batch's M differs; bf16).
5. parity  — the same model cut to 2 layers, in fp32: 4 requests on the
             card (the kernels) and on the CPU (the plain versions) must
             give identical greedy streams and first-token logits within
             atol 1e-3, plain and with quant="int8"; the card's aot="warm"
             run (its decode replayed) must give the same streams (the
             CPU's aot="warm" path is held against paddle_tpu by
             tests/test_torch_aot.py).
5c. durable parity — phase 5's 2-layer cut in fp32 as a 2-replica fleet:
             the journal of an uninterrupted run on the card must equal
             the CPU's byte for byte; a card child killed by a wal.append
             crash at a seeded journal depth and one killed by SIGKILL at
             a seeded depth are each recovered on the card, and every
             stream must equal the CPU's uninterrupted run token for
             token.
5d. elastic parity — 5c's 2-layer fp32 setup: a drain + join fleet (one
             slot a replica, so that r0 holds a queue) and a
             disaggregated fleet on the card give the CPU's streams
             token for token.
4i. decoding at 13B — Llama-2-13B at full width and all 40 layers,
             random weights from seed 0 (LlamaForCausalLM in fp32, 52 GB,
             then .to(bfloat16), 26 GB): (a) generate on 8 seeded
             512-token prompts, 32 new tokens: prefill ms, ms a decode
             step beside the weight-read bound, tokens/s, peak memory;
             no kernel of the eleven launches (its attention is an
             einsum, as the reference's); (b) PagedLlamaEngine over the
             same model (8 slots, 16-token pages, 1024-token window: a
             stacked bf16 copy and a 6.7 GB pool), the same prompts and
             31 steps: exactly 40 paged_decode launches a step, ms a
             step, agreement with (a) reported (bf16: not gated); (c)
             Predictor(model) and Predictor(model, config=Config()) on
             [1, 128] ids: logits equal model(ids) bit for bit; (d) the
             model's serving_params in bf16 on the
             card (the model then dropped) served with quant="int8"
             through phase 4's load with graphs (every request finishes
             with its length; paged_decode_quant once a layer a decode
             step, quant_matmul 7 times a layer a forward), TTFT / TPOT,
             and 8 decode steps at batch 8 beside the int8 weight-read
             bound (both bounds count the weights a step reads: all but
             8 rows of the embedding table).
5e. decoding parity — card against CPU in fp32: (i) 13B's width at 2
             layers: generate, PagedLlamaEngine and ServingEngine on two
             seeded 24-token prompts, 8 new tokens, equal to each other
             and the card's equal to the CPU's; the predictor as in 4i(c)
             and under enable_low_precision("bfloat16"), equal to the
             model cast to bf16 bit for bit and within 2^-4 of the
             largest fp32 logit; (ii) hidden 2560, 32
             heads (head dim 80, outside the kernel's 64 / 128 / 256),
             2 layers, phase 5's load through ServingEngine: the dense
             route (no paged_decode launch, dense calls counted), the
             CPU's streams, and PT_PAGED_IMPL=pallas raises; (iii)
             nn.Transformer at its defaults (seeded weights, dropout 0):
             the forward under generate_square_subsequent_mask within
             1e-5 of the largest value of the CPU's, and 8 one-token
             steps through the decoder with gen_cache equal to the full
             causal forward on both (the encoder's self-attention at S =
             128 takes the short-attention kernel on the card).
5b. feature parity — the same 2-layer fp32 model, 5 requests behind one
             shared prefix with tiled prompts: the prefix cache, spec
             decode and async, each on alone, give the off leg's streams
             on the card and on the CPU, token for token.
6. train   — Llama-2-7B width cut to 8 layers (the only cut: 32 layers of
             fp32 master plus bf16 moments would not fit 80 GB), B=4,
             S=2048, bf16 compute, fp32 master, bf16 moments, full
             recompute, FLAGS_use_fused_rms_norm, lr 1e-4: one warm-up
             step and 5 timed steps through CompiledTrainStep.  Losses
             must be finite and fall; each kernel must launch exactly as
             often per step as full recompute implies.  6b profiles one
             step with torch.profiler.
6d. train S=4096 — Llama-2-7B width x 4 layers at its published 4096-token
             context, B=2 (the same 8192 tokens a step as 6), bf16
             compute, fp32 master, full recompute, attention_impl="auto"
             (the stock-flash region: S > 2048 takes long_attention): 3
             timed steps, exactly 2L forward and L backward attention
             launches per step.
6c. train S=512 — Llama-2-7B width x 2 layers at B=4, S=512 (the short
             kernel's causal region), full recompute: 2 timed steps with
             exactly 2L forward and L backward short-attention launches
             per step and none of the long kernel.
7. train parity — 2 layers at a narrow width that still takes the
             attention kernel (S=1024, D=128, H == KV), fp32: 3 steps on
             the card (kernels) and on the CPU (plain versions) from the
             same weights give losses within 1e-4 relative.
6e. train full — Llama-2-7B at its published shape, all 32 layers,
             on one card: bf16 compute, master_dtype="bfloat16_sr" (the
             bf16 parameters are the master, written back by stochastic
             rounding; 6.738 B parameters x 2 B for parameters, gradients
             and the two bf16 moments), full recompute, B=4, S=2048, lr
             1e-4.  One eager warm-up and 2 timed eager steps, then
             multi_step(3) twice (the first call warms up with the update
             gated off, captures the 3 steps into one CUDA graph and
             replays it; the second only replays).  Losses finite and
             falling; exactly 4L+1 / 2L+1 RMSNorm and 2L / L attention
             launches per step eagerly and under replay; step ms both
             ways, tokens/s, MFU, peak memory.  The training rows of the
             kernel line count this replay's launches.
6f. graph vs eager — phase 6's width at 4 layers (fp32 master): 4 eager
             steps from one state and multi_step(4) from an equal one
             (two models from one seed), twice: losses and every
             parameter, master and moment tensor equal bit for bit; ms a
             step both ways and a traced run of each with its idle
             share.  Again with master_dtype="bfloat16_sr": whether the
             registered SR generator makes replays equal eager (else
             held at relative 2e-2, bf16).
6g. remat policies — full, save_mlp, save_attn and dots at phase 6's
             width, 4 layers: ms a step and peak memory; then loss and every
             gradient in fp32 at the same shape, each policy against full
             within relative 1e-6.
6h. guarded step — a 2-layer cut of 7B (bf16, fp32 master): 3 clean
             guarded_step calls equal 3 step calls bit for bit; a step
             whose loss is poisoned with NaN and one above the
             threshold (loss + 1e6, threshold 1e3) leave every state
             tensor and the step count unchanged.
6i. durable training — a 1-layer cut of Llama-2-7B at full width (B=2,
             S=2048, bf16 compute, fp32 master and moments,
             FLAGS_use_fused_rms_norm) through GuardedTrainStep over a
             CheckpointManager(keep_last_k=2) in a temporary directory,
             checkpoint_every=2: an armed guard.loss_spike is skipped,
             then guard.nan_loss rolls back to the step-2 commit.  Gated:
             the state after the rollback is the commit's snapshot bit
             for bit, the next clean step is the uninterrupted run's bit
             for bit, and a commit of the CUDA state loaded into a CPU
             train step is bit-equal.  The disk's free space, each
             commit's bytes, each save's seconds and GB/s (device to
             host, write, fsync, crc32), the load's and the step time
             while an async save writes.
8. bert train — BERT-base SQuAD fine-tuning as bench.py's BASELINE
             config 2 sets it: BertForQuestionAnswering(BertConfig.base())
             at full width and depth, B=48, S=384, bf16 compute, fp32
             master and moments, lr 3e-5, remat off, dropout 0.1 / 0.1,
             ids and spans from RandomState(0): one warm-up step and 5
             timed ones, every loss finite, exactly 12 forward and 12
             backward short-attention launches per step and no long ones.
             8b profiles one step with torch.profiler.
8c. bert graph — the token-type table's backward (one id 18432 times,
             fp32) 20 times, the library's and the port's
             embedding_grad (which must give one result); then phase
             8's config through multi_step(4) against 4
             eager steps, dropout 0: bit for bit, ms a step and idle share
             both ways; then dropout 0.1 at lr 0 (the state does not
             move): three replays must give three different losses (the
             dropout generators are registered with the graph, so each
             replay draws new masks); then with remat=True (dropout
             0.1): two replays draw different masks, and a replay equals
             the eager remat step from the same generator state bit for
             bit (the recompute draws from a twin of each dropout
             generator registered with the graph).
9. bert parity — 2 layers, hidden 256, 4 heads (D = 64), S = 256, B = 2,
             fp32, dropout 0: 3 steps on the card (the short kernel) and
             on the CPU (the einsum path) from the same weights give
             losses within 1e-4 relative.

3f. grouped kernels — the grouped expert FFN (kernel 10, dense weights)
             and its int8 twin (kernel 11) against their plain versions
             at the MoE bench bucket [8, 2560, 2048] x F = 5504 bf16, at
             C = 20 (a 64-token decode batch), fp32 [4, 256, 256] x 512,
             relu and silu, C = 130, [2, 7, 8, 8], H and F off the
             multiples of 128 through impl="pallas", H above 2048; int8
             at [8, 2560, 2048] and [8, 20, 2048] x 5504, and int8 with H
             and F off the multiples of 128 (and 16) through
             impl="pallas".  Timed beside the bound, the plain version
             and the einsum route; at the bench bucket also GEMM 1 and
             GEMM 2 of the tensor-core route alone.
10. moe train — bench.py's `moe` config (bench.py:1832-1939): its body,
             ep_moe_local forward and backward at T = 8192, H = 2048,
             E = 8, top-2, F = 5504, C = 2560, bf16 tokens and experts,
             fp32 gate; then MoELayer with the same shape on a
             [4, 2048, 2048] bf16 input through CompiledTrainStep (bf16
             compute, fp32 master, lr 1e-4, remat off).  One warm-up and
             5 timed steps each, losses finite, exactly one kernel-10
             launch per step and no kernel-11 launch.  10b profiles one
             MoELayer step with torch.profiler.
10c. moe int8 — ep_moe_local with int8 expert weights at T = 8192 and
             T = 64: one kernel-11 launch per forward, output within a
             relative RMS of 0.05 of the bf16 forward.
11. moe parity — MoELayer at H = 256, F = 512, E = 8, top-2, T = 512,
             fp32: 3 steps on the card (kernel 10) and on the CPU (its
             plain version) give losses within 1e-4 relative.
12. resnet train — bench.py's config 1 (bench.py:621-681): resnet50
             (1000 classes) in training mode, random weights from seed 0,
             B = 256 seeded bf16 images at 224 px and int labels,
             CompiledTrainStep(lr=0.1, compute_dtype="bfloat16",
             loss_fn=cross_entropy) with its defaults (AdamW, fp32
             master, wd 0.01, clip 1.0); with the conv weights NCHW and
             channels-last in turn: 2 warm-up steps (the first timed:
             cuDNN's first calls), 5 timed eager steps, multi_step(5)
             captured and then replayed; step ms, imgs/s, MFU (imgs/s x
             3 x 4.1e9 / 989e12, bench.py's estimate), peak memory and
             the idle share, eager and replayed.  Losses finite; the
             batch norms' running statistics unchanged by every step.
             No kernel of the kernel line lies on this path (cuDNN and
             plain torch).
             (12b, this step traced by family, was cut in PR 19 for
             time: phase 17 traces the eager O1 loop's ResNet-50 step by
             the same families.)
12c. resnet graph — three ResNet-50 steps from one seed (lr 1e-5): two
             models eagerly, one as a replayed multi_step(3); bit for bit
             where cuDNN repeats its bits, else held at bf16's relative
             2e-2.
13. detection train — bench.py's config 4 (bench.py:469-519): ResNet-18
             features with 1x1 box and class heads (Detector, shared
             with 17b and 18), L1 + BCE-with-logits,
             B = 64 at 320 px bf16, lr 1e-3, timed as in 12 (10 eager
             steps).
14. vision parity — fp32, the card against the CPU, with TF32 at the
             library defaults (the script's switch of phase 1 undone for
             the phase): resnet18 and ResNet(BottleneckBlock, 50) eval
             logits at 32 px within 1e-5 of the largest, 3 resnet18 train
             losses within 1e-4 relative, the running statistics after
             an eager train-mode forward within 1e-5 of each buffer's
             largest value (the CPU's fp32 against fp64 beside them);
             the library's own
             conv2d at its TF32 default printed beside the port's.
15. unet train — bench.py's config 5 (bench.py:522-569): the SD v1.5
             UNet (UNet2DConditionModel() at its default widths, 809.9 M
             parameters, random weights from seed 0) under bench.py's
             noise-prediction MSE, B = 4, latents [4, 4, 32, 32] fp32,
             int32 timesteps, a [4, 77, 768] fp32 context and fp32 noise
             from RandomState(0), CompiledTrainStep(lr=1e-4,
             compute_dtype="bfloat16", moments_dtype="bfloat16"): 2
             warm-up steps (the first timed: cuDNN's first calls), 3
             eager steps, multi_step(2) captured and replayed (5 and 3
             until PR 19); step ms,
             samples/s, TFLOP/s over the analytic count (3 x the forward
             flops of the convs, Linears and the two attention products,
             counted from the model's shapes on the meta device), its
             share of the fp32 (67) and bf16 (989 TFLOP/s) peaks, peak
             memory and the idle share, eager and replayed.  Losses
             finite; none of the eleven kernels launches (the step
             computes in fp32 as the reference's does: see
             paddle_tpu_torch/models/unet.py).
15b. unet profile — the port's group_norm against
             torch.nn.functional.group_norm at the top level's shape
             (bits, time).  (One eager step of 15 traced by family with
             testing/vision_profile.py was cut for time; the module
             prints it on its own.)
15c. unet at the published latent — the same model at SD v1.5's own
             sample_size, 64 x 64 latents (512 px images), B = 4: 2
             warm-up and 2 eager steps, multi_step(2) captured and
             replayed; step ms, samples/s, peak memory.  It runs first,
             on the card while nvcc builds the kernels on the host (from
             PR 19; before, after 15b).
16. unet parity — fp32, the card against the CPU, TF32 at the library
             defaults: a narrow UNet at full depth (block_out_channels
             (64, 128, 128, 128), 2 layers a block, cross dim 64, 16 x 16
             latents, B = 2): eval output within 1e-5 of the largest, 3
             train-step losses (lr 1e-4) within 1e-4 relative, and
             interpolate nearest at 5 -> 3 and 8 -> 4 bit for bit.

17. eager resnet — BASELINE config 1 as its row says (BASELINE.md:23):
             resnet50 (1000 classes, fp32 parameters, random from seed
             0), B = 256 at 224 px from io.DataLoader(num_workers=4,
             shuffle=True, drop_last=True) over 768 seeded fp32 images
             with int64 labels (462 MB on the host), Momentum(lr 0.1,
             0.9, L2Decay(1e-4)) (He et al. 2016), GradScaler(), each
             step under auto_cast(O1, bf16): loss.backward via the
             scaler, scaler.step, scaler.update, clear_grad.  One
             warm-up and 5 timed steps: step ms (synchronised wall),
             ms waited on the loader, imgs/s, MFU, peak memory, the
             scale; one traced step by family (device busy, idle share)
             beside phase 12's replayed CompiledTrainStep.
17b. eager detection O2 — BASELINE config 4 as its row says
             (BASELINE.md:26): phase 13's detector (bench.py:484-499),
             B = 64 at 320 px, decorate(O2), AdamW(1e-3),
             GradScaler(2**10), auto_cast(O2), 5 steps: norms fp32, the
             rest bf16, master weights fp32; step ms, imgs/s, peak.
17c. eager parity — the card against the CPU: ResNet-18 (64 px, B = 4)
             and the tiny detector, 3 eager steps each without AMP, at
             O1 and at O2 from the same weights (losses within rtol 1e-4
             fp32, 2e-2 bf16; each parameter's change over the steps,
             its master weight's under O2, and each accumulator slot,
             all parameters together, within 0.1 fp32 (cuDNN's TF32),
             0.25 bf16 of the CPU's in norm, where a skipped update is
             1 off and one off by a factor k is |k - 1|; the
             scalers' states equal); a
             mark_found_inf step leaves parameters and accumulators bit
             for bit; a 2-worker loader gives a 0-worker one's batches;
             an armed io.worker fault raises DataLoaderWorkerError
             naming the batch.
17d. zoo — every family's constructor at its published width (1000
             classes; LeNet 10 at 28 x 28), eval forward at B = 2 and
             224 px (Inception v3 299), fp32, card against CPU within
             1e-5 of the largest logit; one O1 train step of each on the
             card with a finite loss.  Phases 17-17d launch none of the
             eleven kernels.
18. detection eval — BASELINE config 4's eval side: (a) phase 13's
             detector (one class, Detector, shared by 13, 17b and 18) in
             eval, decorate(O2) + auto_cast(O2), B = 64 at 320 px; boxes
             decoded as tests/test_detection_amp.py:84-92 does (cell
             centres at stride 32 -+ |offset| x 32, rounded to 1/16 px),
             sigmoid scores; per image the top 1000 (cell, class) pairs
             (a stable sort), class-aware nms at IoU 0.7 keeping 300
             (PP-YOLOE+'s MultiClassNMS settings).  Eager nms (float64)
             on the card must keep the CPU's indices exactly on the same
             fp32 candidates; the fixed-size float32 route, batched over
             the 64 images and nms itself for image 0, captured in a CUDA
             graph and replayed, must equal the eager route's first
             count entries (padding -1 after) in every image with no IoU
             within 1e-6 of the threshold.  Forward ms, decode + nms ms,
             images/s, the replay's ms.  (b) each op at a published
             size, card against the port on the CPU (1e-5 of the largest
             value, integers equal), timed: roi_align on a Mask R-CNN FPN
             P2 map [2, 256, 200, 336] with 512 ROIs an image at 7x7 and
             14x14, sampling ratio -1 and 2 (held at 64 ROIs an image,
             timed at 512), roi_pool and psroi_pool (R-FCN's 7 x 7 x 81
             maps) at 7x7, yolo_box on YOLOv3's three 608-px heads,
             generate_proposals at 2000 / 1000, matrix_nms at 80
             classes, deform_conv2d v2 at [8, 512, 19, 19] (PP-YOLOv2's
             DCN stage), Conv2DTranspose, Conv1D, Conv3D and
             Conv3DTranspose, the index pool with max_unpool and the
             ceil-mode pools, bicubic interpolate up and down and
             gelu(approximate=True).  None of the eleven kernels
             launches in 18.
19. op namespace — ``import paddle_tpu_torch as paddle``'s flat op
             families (PR 21): (a) every op of the CPU tests' tables
             (math, activation, in-place, reduction, manipulation,
             creation) on the card and on the CPU from the same seeded
             numpy inputs, fp32 and bf16: dtypes and shapes equal,
             integers and bools exactly, floats within the CPU tests'
             tolerances (2e-6 fp32, 1.6e-2 bf16, of the largest value),
             and every differentiable fp32 op's gradients through
             autograd on both; (b) draws repeat under ``seed`` and under
             ``set_rng_state``, and the moments of rand, randn and
             randint at 2^20 samples fall within 6 standard errors; (c)
             ``paddle.save`` of CUDA tensors in fp32, bf16 and int64,
             ``paddle.load`` back bit for bit; (d) a user's MLP script
             written with ``paddle.*`` names only (to_tensor,
             create_parameter, matmul, tanh, mean, subtract_, seed) takes
             50 steps on the card and on the CPU: the loss falls, the
             card's losses equal the CPU's within rtol 1e-4, and the
             steps' wall time is printed; (e) a tensor made with no place
             lies on cuda:0.  None of the eleven kernels launches in 19.
20. nn     — ``paddle.nn`` as a user drives it: (a) GPT-2 small
             (Radford et al. 2019, the ``gpt2`` config: 12 layers, 768
             wide, 12 heads, FFN 3072, vocab 50257, context 1024, the
             head tied) written as a ``paddle.nn.Layer`` script from
             ``Embedding``, ``LayerNorm``, ``Linear``, ``GELU``,
             ``Dropout(0.1)``, ``LayerList`` and ``CrossEntropyLoss`` at
             the reference's defaults, attention through
             ``F.flash_attention(dropout=0.1, causal=True)``, trained 10
             AdamW steps under decorate(O2, bf16) + auto_cast at B = 8,
             S = 1024: ms a step, tokens/s, MFU (6N + 12LdS flops a
             token over 989 TFLOP/s), peak memory, the loss (it must
             fall); the short-attention kernels launch 12 + 12 times a
             step, and a traced step runs no library attention kernel;
             (b) ``F.flash_attn_qkvpacked`` at [2, 2048, 3, 16, 128]
             bf16, causal, forward and backward: the long-attention
             kernels launch once each and agree with their plain
             versions (3b's tolerances); (c) the PTB "large" LSTM
             language model (Zaremba et al. 2014: 2 layers, 1500
             hidden, 35 steps, batch 20, vocab 10000, dropout 0.65,
             U(-0.04, 0.04) by ``ParamAttr``), 10 SGD steps with
             ``ClipGradByGlobalNorm(5.0)``: ms a step and the losses;
             (d) card = CPU: 76 layers and functional ops (values and
             fp32 gradients within 1e-5 of the largest), and a 2-layer
             GPT (the short kernel on the card) and a narrow LSTM with
             the same weights, losses within 1e-4 over 3 steps, dropout
             0 (on the CPU the attention takes the einsum route, whose
             dropout mask is not the kernel's hash mask).  The kernel
             line's rows 6-9 carry 20a's and 20b's launches as
             ``nn_launches``.

The line before the last is one JSON object with a row per kernel; the
last line is {"ok": true, "device": {...}}.  Imports nothing of JAX or
of paddle_tpu.
"""
from __future__ import annotations

import collections
import gc
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense


def log(*a):
    print(*a, flush=True)


# -- phase 1 -----------------------------------------------------------------

def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    limit = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    drv = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {name} | {limit} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | NVIDIA driver {drv} (stream capture "
        f"keeps programmatic dependent launches from CUDA 12.3) | TF32 off "
        f"for matmul and cuDNN")
    return name, limit


# -- phase 2 -----------------------------------------------------------------

def phase_build():
    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    wall = time.perf_counter() - t0
    for name, rec in info.items():
        entries = _ptxas_entries(rec["log"])
        log(f"[build] {name}: {rec['seconds']:.1f} s; {len(entries)} "
            f"kernel instantiations; max registers "
            f"{max((e['regs'] for e in entries), default=None)}; "
            f"spilling instantiations "
            f"{sum(1 for e in entries if e['spill'])}")
        for e in entries:
            log(f"[build]   {e['name']}: {e['regs']} registers, "
                f"{e['smem']} bytes static shared memory, spill stores/"
                f"loads {e['spill_st']}/{e['spill_ld']} bytes")
    log(f"[build] all kernels in {wall:.1f} s")
    from paddle_tpu_torch.ops.kernels import long_attention, rms_norm

    log(f"[build] dynamic shared memory per block: "
        f"{long_attention.smem_bytes()} (long_attention), "
        f"{rms_norm.smem_bytes(4096)} (rms_norm at h=4096)")
    check_sass(_build)


def check_sass(build):
    """What the built libraries' SASS (cuobjdump -sass) must hold:
    ``HGMMA`` (wgmma) in every instantiation of ``attn_wg_*``
    (attention), ``sattn_*_wg_kernel`` (short attention),
    ``gffn_wg_kernel`` (the grouped expert FFN's two GEMMs, bf16 and int8
    weights) and ``qmm_wg_kernel`` (the int8-weight matmul's prefill
    GEMM), ``HMMA`` (mma.sync) in every ``qmm_dec_kernel`` (its decode
    GEMV), and ``UBLKCP`` (cp.async.bulk, the page copies) in every
    instantiation of ``paged_decode_split_kernel`` and
    ``paged_decode_quant_split_kernel``; no ``I2F`` (int-to-float) in the
    two ``qmm_`` tensor-core kernels.  Raises if one holds none, or if
    there are not six attention, twelve short-attention, four grouped,
    55 paged-decode, one prefill and four decode instantiations."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    # (library, kernel pattern, instantiations, instruction that each must
    # hold, instruction that none may hold)
    expect = [("long_attention", r"(attn_wg_\w+?_kernel)I(Lb[01])E", 6,
               "HGMMA", None),
              ("short_attention", r"(sattn_\w+?_wg_kernel)I(Li\d+ELb[01])E",
               12, "HGMMA", None),
              ("grouped_gemm", r"(gffn_wg_kernel)I(\w+?Li[12])E", 4,
               "HGMMA", None),
              ("paged_decode", r"\d(paged_decode\w*?_split_kernel)I(\w+?)EEv",
               55, "UBLKCP", None),
              # the int8-weight matmul's tensor-core routes: wgmma in the
              # prefill GEMM, mma.sync in the decode GEMV, and no
              # quarter-rate int-to-float conversion in either
              ("quant_matmul", r"\d(qmm_wg_kernel)()E", 1, "HGMMA", "I2F"),
              ("quant_matmul", r"\d(qmm_dec_kernel)I(Li\d+)E", 4, "HMMA",
               "I2F")]
    # one cuobjdump per library, all started together
    procs = {lib: subprocess.Popen([tool, "-sass", str(build._target(lib))],
                                   stdout=subprocess.PIPE, text=True)
             for lib in dict.fromkeys(e[0] for e in expect)}
    sass_of = {}
    for lib, proc in procs.items():
        sass_of[lib] = proc.communicate(timeout=120)[0]
        if proc.returncode:
            raise AssertionError(f"[build] cuobjdump -sass {lib} exited "
                                 f"{proc.returncode}")
    for lib, pattern, count, instr, forbid in expect:
        found, banned = {}, {}
        for chunk in sass_of[lib].split("Function : ")[1:]:
            m = re.search(pattern, chunk.split()[0])
            if m:
                key = f"{m.group(1)}<{_template_args(m.group(2))}>"
                found[key] = chunk.count(instr)
                if forbid:
                    banned[key] = chunk.count(forbid)
        log(f"[build] {instr} instructions per instantiation of {lib} "
            f"(cuobjdump -sass): {found}"
            + (f"; {forbid}: {banned}" if forbid else ""))
        if len(found) != count or not all(found.values()):
            raise AssertionError(f"[build] expected {instr} in the {count} "
                                 f"instantiations of {lib}, found {found}")
        if any(banned.values()):
            raise AssertionError(f"[build] {forbid} in {lib}: {banned}")


def _template_args(mangled):
    """'f13__nv_bfloat16Li128ELi1' -> 'f32,bf16,128,1' (Itanium
    mangling of the types and integers our kernels are templated on)."""
    import re

    names = {"13__nv_bfloat16": "bf16", "f": "f32", "a": "int8"}
    out = []
    while mangled:
        tok = next((t for t in names if mangled.startswith(t)), None)
        if tok:
            out.append(names[tok])
            mangled = mangled[len(tok):]
            continue
        m = re.match(r"S\d*_", mangled)     # a type named before
        if m and out:
            out.append(out[-1])
            mangled = mangled[m.end():]
            continue
        m = re.match(r"L[ib](\d+)E?", mangled)
        if not m:
            out.append(mangled)
            break
        out.append(m.group(1))
        mangled = mangled[m.end():]
    return ",".join(out)


def _ptxas_entries(text):
    """One record per kernel instantiation from ``nvcc -Xptxas -v``."""
    import re

    out, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            # <len><name>_kernel<template args>Ev: keep name and args
            short = re.search(r"\d((?:attn|sattn|rms_norm|paged_decode|qmm|gffn)"
                              r"\w*?_kernel)(I\w*?E)?E", m.group(1))
            cur = {"name": (short.group(1) + (short.group(2) or ""))
                   if short else m.group(1),
                   "regs": None, "smem": 0, "spill_st": 0, "spill_ld": 0,
                   "spill": False}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_st"], cur["spill_ld"] = int(m[1]), int(m[2])
            cur["spill"] = cur["spill_st"] + cur["spill_ld"] > 0
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["regs"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(m[1]) if m else 0
    return out


# -- phase 3 -----------------------------------------------------------------

def _flush_l2(buf):
    buf.zero_()


def time_ms(fn, flush, iters=50, warmup=5):
    """Mean milliseconds of ``fn`` over ``iters`` launches, each timed by
    its own CUDA events after an L2 flush (the serving loop finds the
    layer's pool cold: the other 31 layers ran in between)."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        _flush_l2(flush)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


BF16_WHY = "bf16 output: the two fp32 results may round to neighbouring " \
    "bf16 values, one ulp <= 2^-7 |want|"


def _hold(label, got, want, atol, rtol, why):
    """Fail unless ``got`` (a kernel's output) is finite, has ``want``'s
    dtype and shape, and |got - want| <= atol + rtol * |want| everywhere.
    Returns the largest absolute error."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"[kernels] {label}: got {got.dtype} "
                             f"{tuple(got.shape)}, want {want.dtype} "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"[kernels] {label}: non-finite output")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    over = (diff - (atol + rtol * want.float().abs())).max().item()
    log(f"[kernels] {label}: max_abs_err {err:.3e} (atol {atol:g} + rtol "
        f"{rtol:g} * |want|: {why})")
    if not over <= 0:
        raise AssertionError(f"[kernels] {label}: max_abs_err {err}, "
                             f"{over} over atol {atol} + rtol {rtol} * "
                             "|want|")
    return err


def make_paged_case(gen, B, KV, G, D, ps, pps, lengths, q_dtype, kv_dtype,
                    device):
    """Pool with one distinct page per (sequence, window slot) plus one
    NaN page that every slot past a sequence's cover points at; the
    unwritten tail of each last page is NaN too."""
    P = B * pps + 1
    nan_page = P - 1
    kp = torch.randn(KV, P, ps, D, generator=gen, device=device)
    vp = torch.randn(KV, P, ps, D, generator=gen, device=device)
    table = torch.arange(B * pps, device=device,
                         dtype=torch.int32).reshape(B, pps)
    for b, n in enumerate(lengths):
        cover = -(-n // ps)
        table[b, cover:] = nan_page
        last = int(table[b, cover - 1])
        if n % ps:
            kp[:, last, n % ps:] = float("nan")
            vp[:, last, n % ps:] = float("nan")
    kp[:, nan_page] = float("nan")
    vp[:, nan_page] = float("nan")
    q = torch.randn(B, KV * G, D, generator=gen, device=device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return (q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype), lens, table)


def paged_decode_bound(q, k_pages, lengths, page_indices):
    """(bound_ms, bound_by): bytes that must move — K and V rows under
    each length, the table entries of the covering pages, lengths, q in,
    out — over HBM rate, against 4 flops per (query row, token, dim)
    over the fp32 rate the kernel computes at."""
    B, H, D = q.shape
    KV, _, ps, _ = k_pages.shape
    lens = [int(x) for x in lengths.cpu()]
    tokens = sum(lens)
    nbytes = (2 * tokens * KV * D * k_pages.element_size()
              + sum(-(-n // ps) for n in lens) * 4 + B * 4
              + 2 * q.numel() * q.element_size())
    flops = 4 * tokens * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: shapes the first paged-decode kernel refused, and lengths on, one past
#: and inside the 256-token split boundary and 0 (phases 3 and 3c)
PAGED_NEW_CASES = [
    ("G=8 window 8192", dict(B=2, KV=4, G=8, D=128, ps=16, pps=512,
                             lengths=[8192, 6500])),
    ("MQA G=32 window 4096", dict(B=4, KV=1, G=32, D=128, ps=16, pps=256,
                                  lengths=[4096, 3000, 17, 1])),
    ("D=256 G=2", dict(B=3, KV=4, G=2, D=256, ps=16, pps=64,
                       lengths=[1024, 700, 5])),
    ("split boundaries, length 0", dict(B=6, KV=8, G=1, D=128, ps=16,
                                        pps=64, lengths=[256, 257, 512, 513,
                                                         0, 255])),
    # pages wider than a ring stage's 16 KB stream in tiles of rows
    ("pages of 128 tokens, D=256", dict(B=2, KV=2, G=2, D=256, ps=128,
                                        pps=4, lengths=[500, 129])),
]
#: phase 4b's decode step: batch 8, every sequence 522 tokens long
PAGED_SERVING = dict(B=8, KV=32, G=1, D=128, ps=16, pps=128,
                     lengths=[522] * 8)
#: Llama-2-13B (40 kv heads) at phase 4i's PagedLlamaEngine: ragged
#: lengths in its 1024-token window, and its decode step (8 sequences
#: of a 512-token prompt and 32 new tokens at the last step)
L13B = [1, 8, 1024, 17, 500, 544, 999, 333]
PAGED_13B = dict(B=8, KV=40, G=1, D=128, ps=16, pps=64, lengths=[543] * 8)


def _paged_dense(q, table, pages, scales=None):
    """Each sequence's page window gathered dense [B, KV, T, D] (fp32,
    dequantized with ``scales``): the library yardstick's input."""
    B, _, D = q.shape
    T = table.shape[1] * pages.shape[2]
    idx = table.long()
    w = pages[:, idx].float()
    if scales is not None:
        w = w * scales[:, idx][..., None, None]
    return w.transpose(0, 1).reshape(B, -1, T, D)


def _time_paged_13b(label, kernel, plain, bound_fn, args, flush, dense_kv):
    """One extra shape line of a paged-decode row at 4i's decode step:
    kernel, bound, plain and library times."""
    ms = time_ms(lambda: kernel(*args), flush)
    plain_ms = time_ms(lambda: plain(*args), flush)
    lib_ms = _paged_library_ms(args[0], *dense_kv, args[3], flush)
    bound, by = bound_fn(args[0], args[1], args[3], args[4])
    log(f"[kernels] {label} time at 4i's decode step (Llama-2-13B: B=8, "
        f"KV=40, D=128, ps=16, pps=64, every length 543): kernel "
        f"{ms:.4f} ms | bound {bound:.4f} ms ({by}) | plain {plain_ms:.4f} "
        f"ms | library_ms {lib_ms:.4f} ms | {100 * bound / ms:.1f}% of "
        f"bound | {lib_ms / ms:.2f}x faster than the library")


def _paged_library_ms(q, kd, vd, lens, flush, iters=50):
    """SDPA (bf16) over dense caches kd / vd [B, KV, T, D] already
    gathered, masked to the lengths: the library yardstick."""
    B, _, T, _ = kd.shape
    valid = torch.arange(T, device=q.device)[None] < lens[:, None]
    kd = torch.where(valid[:, None, :, None], kd, 0).to(torch.bfloat16)
    vd = torch.where(valid[:, None, :, None], vd, 0).to(torch.bfloat16)
    qs, mask = q.to(torch.bfloat16)[:, :, None], valid[:, None, None, :]
    F = torch.nn.functional
    return time_ms(
        lambda: F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mask),
        flush, iters=iters)


def phase_kernels(device):
    from paddle_tpu_torch.ops.kernels import paged_decode as pdmod

    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    f32, bf16 = torch.float32, torch.bfloat16
    # ragged lengths: 1 token, mid-page, the full 2048 window, and more
    l7b = [1, 8, 2048, 17, 500, 1024, 1999, 333]
    # (label, shape, (q dtype, pool dtype), atol, rtol, reason); an
    # element passes when |got - want| <= atol + rtol * |want|
    cases = [
        ("llama2-7b serving (q f32, pool bf16)",
         dict(B=8, KV=32, G=1, D=128, ps=16, pps=128, lengths=l7b),
         (f32, bf16), 2e-5, 0.0, "fp32 math on bf16-exact values, other "
         "summation order"),
        ("llama2-7b fp32", dict(B=8, KV=32, G=1, D=128, ps=16, pps=128,
                                lengths=l7b),
         (f32, f32), 2e-5, 0.0, "fp32 throughout, other summation order"),
        ("llama2-7b bf16", dict(B=8, KV=32, G=1, D=128, ps=16, pps=128,
                                lengths=l7b),
         (bf16, bf16), 1e-4, 2 ** -7, BF16_WHY),
        ("llama2-13b serving (q f32, pool bf16)",
         dict(B=8, KV=40, G=1, D=128, ps=16, pps=64, lengths=L13B),
         (f32, bf16), 2e-5, 0.0, "fp32 math on bf16-exact values, other "
         "summation order"),
        ("gqa G=4 D=128", dict(B=4, KV=8, G=4, D=128, ps=16, pps=128,
                               lengths=[2048, 1, 40, 777]),
         (f32, bf16), 2e-5, 0.0, "fp32 math, other summation order"),
        ("gqa G=2 D=64", dict(B=3, KV=4, G=2, D=64, ps=16, pps=32,
                              lengths=[512, 9, 100]),
         (f32, f32), 2e-5, 0.0, "fp32 throughout, other summation order"),
    ] + [(label, shape, (f32, bf16), 2e-5, 0.0, "fp32 math on bf16-exact "
          "values, other summation order")
         for label, shape in PAGED_NEW_CASES] + [
        ("D=256 G=2 bf16", dict(B=3, KV=4, G=2, D=256, ps=16, pps=64,
                                lengths=[1024, 700, 5]),
         (bf16, bf16), 1e-4, 2 ** -7, BF16_WHY),
    ]
    main_row = None
    for label, shape, (qd, kd), atol, rtol, why in cases:
        args = make_paged_case(gen, q_dtype=qd, kv_dtype=kd, device=device,
                               **shape)
        got = pdmod.paged_decode(*args)
        torch.cuda.synchronize()
        want = pdmod.paged_decode_reference(*args)
        # a non-finite output would mean NaN pages leaked in
        err = _hold(f"paged_decode {label}", got, want, atol, rtol, why)
        if main_row is None:
            main_row = (args, err)

    # timing at the serving path's shapes and dtypes
    args, err = main_row
    q, kp, vp, lens, table = args
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8,
                        device=device)
    before = pdmod.paged_decode.launches

    def dense(pages):
        B, _, D = q.shape
        T = table.shape[1] * pages.shape[2]
        return pages[:, table.long()].transpose(0, 1).reshape(B, -1, T, D)

    ms = time_ms(lambda: pdmod.paged_decode(*args), flush)
    plain_ms = time_ms(lambda: pdmod.paged_decode_reference(*args), flush)
    # library yardstick: SDPA over the dense cache ALREADY gathered
    # (the gather is excluded), bf16 q, boolean length mask
    library_ms = _paged_library_ms(q, dense(kp), dense(vp), lens, flush)
    bound_ms, bound_by = paged_decode_bound(q, kp, lens, table)
    plan = pdmod.split_plan(8, 32, 1, 128, 16, 128)
    log(f"[kernels] paged_decode time at B=8 KV=32 D=128 ps=16 pps=128, "
        f"lengths {[int(x) for x in lens.cpu()]}, q f32 / pool bf16 "
        f"({plan['n_split']} splits of {plan['split_pages']} pages): "
        f"kernel {ms:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}: "
        f"K/V read over {HBM_BYTES_PER_S / 1e12:g} TB/s) | plain "
        f"{plain_ms:.4f} ms | library_ms {library_ms:.4f} ms "
        f"(scaled_dot_product_attention, bf16, over the gathered dense "
        f"cache, gather excluded) | {100 * bound_ms / ms:.1f}% of bound | "
        f"{library_ms / ms:.2f}x faster than the library")
    sargs = make_paged_case(gen, q_dtype=f32, kv_dtype=bf16, device=device,
                            **PAGED_SERVING)
    s_ms = time_ms(lambda: pdmod.paged_decode(*sargs), flush)
    s_bound, _ = paged_decode_bound(sargs[0], sargs[1], sargs[3], sargs[4])
    log(f"[kernels] paged_decode time at phase 4b's decode step (B=8, every "
        f"length 522, q f32 / pool bf16): kernel {s_ms:.4f} ms | bound "
        f"{s_bound:.4f} ms | {100 * s_bound / s_ms:.1f}% of bound")
    sargs = make_paged_case(gen, q_dtype=f32, kv_dtype=bf16, device=device,
                            **PAGED_13B)
    _time_paged_13b("paged_decode", pdmod.paged_decode,
                    pdmod.paged_decode_reference, paged_decode_bound, sargs,
                    flush, (_paged_dense(sargs[0], sargs[4], sargs[1]),
                            _paged_dense(sargs[0], sargs[4], sargs[2])))
    pdmod.paged_decode.launches = before   # timing launches do not count
    del flush, sargs
    return {"name": "paged_decode", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels/paged_decode.py:118",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# -- phase 3b: the training kernels -------------------------------------------

TRAIN_SHAPE = dict(B=4, H=32, S=2048, D=128, h=4096)
def rms_norm_bounds(N, h, x_bytes, w_bytes):
    """(fwd, bwd) (bound_ms, bound_by): each input read once, each output
    written once, over HBM rate, against ~4 flops per element (fwd) and
    ~8 (bwd) over the fp32 rate."""
    fwd_b = 2 * N * h * x_bytes + h * w_bytes + 4 * N
    bwd_b = 3 * N * h * x_bytes + h * w_bytes + 4 * N
    out = []
    for nbytes, flops in ((fwd_b, 4 * N * h), (bwd_b, 8 * N * h)):
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        to = flops / FP32_FLOPS * 1e3
        out.append((tb, "bytes") if tb >= to else (to, "operations"))
    return out


def attention_bounds(B, H, S, D, elem_bytes, causal=True, Hkv=None):
    """(fwd, bwd) (bound_ms, bound_by): the multiply-adds of the causal
    (i, j <= i) pairs (all pairs when not causal), two products forward
    and five backward, over the bf16 tensor-core rate (fp32 inputs: the
    fp32 rate), against q, k, v, out (and g, dq, dk, dv) moved once over
    HBM rate; k, v, dk, dv have Hkv heads."""
    Hkv = H if Hkv is None else Hkv
    pairs = S * (S + 1) // 2 if causal else S * S
    rate = BF16_FLOPS if elem_bytes == 2 else FP32_FLOPS
    one = B * H * S * D * elem_bytes
    kv = B * Hkv * S * D * elem_bytes
    out = []
    for n_products, nbytes in ((2, 2 * one + 2 * kv + 4 * B * H * S),
                               (5, 4 * one + 4 * kv + 4 * B * H * S)):
        to = n_products * 2 * B * H * pairs * D / rate * 1e3
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        out.append((to, "operations") if to >= tb else (tb, "bytes"))
    return out


def phase_train_kernels(device, iters=20):
    """The four training kernels against their plain versions, then timed
    at the training path's shapes.  Returns their rows (no launches)."""
    from paddle_tpu_torch.ops.kernels import long_attention as la
    from paddle_tpu_torch.ops.kernels import rms_norm as rn

    F = torch.nn.functional
    gen = torch.Generator(device=device)
    gen.manual_seed(4321)
    f32, bf16 = torch.float32, torch.bfloat16
    B, H, S, D, h = (TRAIN_SHAPE[k] for k in "BHSDh")
    before = {f: f.launches for f in (rn.rms_norm_fwd, rn.rms_norm_bwd,
                                      la.attention_fwd, la.attention_bwd)}
    eps = 1e-5

    # RMSNorm: (rows, x dtype, w dtype, atol, rtol, why)
    norm_cases = [
        (B * S, bf16, f32, 1e-6, 2 ** -7, BF16_WHY),
        (B * 1024, bf16, f32, 1e-6, 2 ** -7, BF16_WHY),
        (B * S, bf16, bf16, 1e-6, 2 ** -7, BF16_WHY),
        (B * S, f32, f32, 1e-5, 0.0, "fp32 throughout, other summation "
         "order"),
    ]
    norm_err = {}
    for N, xd, wd, atol, rtol, why in norm_cases:
        x = torch.randn(N, h, generator=gen, device=device).to(xd)
        w = (1 + 0.1 * torch.randn(h, generator=gen, device=device)).to(wd)
        dy = torch.randn(N, h, generator=gen, device=device).to(xd)
        out, rstd = rn.rms_norm_fwd(x, w, eps)
        dx = rn.rms_norm_bwd(x, w, rstd, dy)
        torch.cuda.synchronize()
        want, wrstd = rn.rms_norm_fwd_reference(x, w, eps)
        wdx = rn.rms_norm_bwd_reference(x, w, wrstd, dy)
        tag = f"N={N} h={h} x {xd} w {wd}"
        e1 = _hold(f"rms_norm_fwd {tag}", out, want, atol, rtol, why)
        _hold(f"rms_norm_fwd rstd {tag}", rstd, wrstd, 1e-6, 1e-5,
              "fp32, other summation order")
        e2 = _hold(f"rms_norm_bwd {tag}", dx, wdx, atol, rtol, why)
        norm_err.setdefault("fwd", e1)
        norm_err.setdefault("bwd", e2)

    # attention: (B, H, Hkv, S, dtype, rope_base, causal); bf16 without
    # RoPE takes the tensor-core kernels, the rest the fp32-core ones
    attn_cases = [(B, H, H, S, bf16, None, True),
                  (B, H, H, 1024, bf16, None, True),
                  (B, H, H, S, f32, None, True),
                  (B, H, H, S, bf16, 10000.0, True),
                  (2, H, 8, 4096, bf16, None, True),     # GQA 32/8
                  (B, H, H, S, bf16, None, False),       # not causal
                  (2, H, H, 4096, bf16, None, True)]     # S = 4096
    attn_err = {}
    scale = 1.0 / np.sqrt(D)
    for b, hh, hkv, s, dt, rb, causal in attn_cases:
        q, g = (torch.randn(b, hh, s, D, generator=gen,
                            device=device).to(dt) for _ in range(2))
        k, v = (torch.randn(b, hkv, s, D, generator=gen,
                            device=device).to(dt) for _ in range(2))
        out, lse = la.attention_fwd(q, k, v, scale, causal, rb)
        grads = la.attention_bwd(q, k, v, out, lse, g, scale, causal, rb)
        torch.cuda.synchronize()
        wout, wlse = la.attention_fwd_plain(q, k, v, scale, causal, rb)
        tag = (f"B={b} H={hh} Hkv={hkv} S={s} D={D} {dt} rope_base={rb} "
               f"causal={causal}")
        if dt == f32:
            tol = dict(out=(2e-5, 0.0), lse=(2e-5, 0.0), grad=(1e-4, 0.0))
            why = "fp32 throughout, other summation order"
            gwhy = why
        else:
            tol = dict(out=(2e-3, 2 ** -7), lse=(1e-3, 0.0),
                       grad=(5e-3, 2 ** -6))
            why = BF16_WHY
            gwhy = ("bf16 outputs of sums over up to 4 x 4096 fp32 terms "
                    "(P and dS enter the tensor cores as bf16 hi + lo)")
        e1 = _hold(f"attention_fwd out {tag}", out, wout, *tol["out"], why)
        _hold(f"attention_fwd lse {tag}", lse, wlse, *tol["lse"],
              "fp32, other summation order")
        del wout, wlse
        torch.cuda.empty_cache()
        wgrads = la.attention_bwd_plain(q, k, v, out, lse, g, scale,
                                        causal, rb)
        errs = [_hold(f"attention_bwd {n} {tag}", a, w_, *tol["grad"], gwhy)
                for n, a, w_ in zip(("dq", "dk", "dv"), grads, wgrads)]
        attn_err.setdefault("fwd", e1)
        attn_err.setdefault("bwd", max(errs))
        del wgrads, grads, q, k, v, g, out, lse
        torch.cuda.empty_cache()

    # timing at the training path's shapes and dtypes
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=device)
    x = torch.randn(B * S, h, generator=gen, device=device).to(bf16)
    w = torch.ones(h, device=device)
    dy = torch.randn(B * S, h, generator=gen, device=device).to(bf16)
    _, rstd = rn.rms_norm_fwd(x, w, eps)
    xl = x.detach().requires_grad_(True)
    wb = w.to(bf16)
    yl = F.rms_norm(xl, (h,), wb, eps)
    t = {
        "rms_norm_fwd": (
            lambda: rn.rms_norm_fwd(x, w, eps),
            lambda: rn.rms_norm_fwd_reference(x, w, eps),
            lambda: F.rms_norm(x, (h,), wb, eps)),
        "rms_norm_bwd": (
            lambda: rn.rms_norm_bwd(x, w, rstd, dy),
            lambda: rn.rms_norm_bwd_reference(x, w, rstd, dy),
            lambda: torch.autograd.grad(yl, xl, dy, retain_graph=True)),
    }
    times = {name: [time_ms(f, flush, iters=iters) for f in fns]
             for name, fns in t.items()}
    del x, dy, xl, yl
    q, k, v, g = (torch.randn(B, H, S, D, generator=gen,
                              device=device).to(bf16) for _ in range(4))
    out, lse = la.attention_fwd(q, k, v, scale, True)
    ql, kl, vl = (a.detach().requires_grad_(True) for a in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    t = {
        "attention_fwd": (
            lambda: la.attention_fwd(q, k, v, scale, True),
            lambda: la.attention_fwd_reference(q, k, v, scale, True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
        "attention_bwd": (
            lambda: la.attention_bwd(q, k, v, out, lse, g, scale, True),
            lambda: la.attention_bwd_reference(q, k, v, out, lse, g, scale,
                                               True),
            lambda: torch.autograd.grad(ol, (ql, kl, vl), g,
                                        retain_graph=True)),
    }
    for name, fns in t.items():
        times[name] = [time_ms(f, flush, iters=iters) for f in fns]
    del q, k, v, g, out, lse, ql, kl, vl, ol
    torch.cuda.empty_cache()
    flash_region_times(la, gen, flush, iters)
    del flush
    torch.cuda.empty_cache()
    for f, n in before.items():        # checks and timing do not count
        f.launches = n

    nb = rms_norm_bounds(B * S, h, 2, 4)
    ab = attention_bounds(B, H, S, D, 2)
    meta = {
        "rms_norm_fwd": ("csrc/rms_norm.cu", "rms_norm.py:72", nb[0],
                         norm_err["fwd"], "F.rms_norm, bf16 weight",
                         f"x [{B * S}, {h}] bf16, w fp32"),
        "rms_norm_bwd": ("csrc/rms_norm.cu", "rms_norm.py:103", nb[1],
                         norm_err["bwd"], "autograd of F.rms_norm, dx only",
                         f"x, dy [{B * S}, {h}] bf16, w fp32"),
        "attention_fwd": ("csrc/long_attention.cu", "long_attention.py:147",
                          ab[0], attn_err["fwd"],
                          "scaled_dot_product_attention(is_causal=True)",
                          f"q/k/v [{B}, {H}, {S}, {D}] bf16, causal"),
        "attention_bwd": ("csrc/long_attention.cu", "long_attention.py:168",
                          ab[1], attn_err["bwd"],
                          "autograd of scaled_dot_product_attention",
                          f"q/k/v/g [{B}, {H}, {S}, {D}] bf16, causal"),
    }
    rows = []
    for name, (src, rep, (bound, by), err, lib, shape) in meta.items():
        ms, plain_ms, library_ms = times[name]
        log(f"[kernels] {name} time at {shape}: kernel {ms:.4f} ms | "
            f"bound {bound:.4f} ms ({by}) | plain {plain_ms:.4f} ms | "
            f"library_ms {library_ms:.4f} ms ({lib}) | "
            f"{100 * bound / ms:.1f}% of bound")
        rows.append({"name": name, "route": "cuda",
                     "source": f"paddle_tpu_torch/{src}",
                     "replaces": f"paddle_tpu/ops/pallas_kernels/{rep}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": library_ms})
    return rows


FLASH_SHAPES = [  # (label, B, H, Hkv): the stock-flash region, S = 4096
    ("causal S=4096", 2, 32, 32),
    ("causal S=4096, GQA 32/8 (Llama-3-8B's head layout)", 2, 32, 8)]


def flash_region_times(la, gen, flush, iters, S=4096, D=128):
    """Kernel, plain and SDPA times (forward, backward) at the flash
    region's shapes, bf16 causal, beside the bound; logged, not rows of
    the kernels line (the rows time the training shape)."""
    F = torch.nn.functional
    bf16 = torch.bfloat16
    scale = 1.0 / np.sqrt(D)
    for label, B, H, Hkv in FLASH_SHAPES:
        q, g = (torch.randn(B, H, S, D, generator=gen, device=flush.device)
                .to(bf16) for _ in range(2))
        k, v = (torch.randn(B, Hkv, S, D, generator=gen, device=flush.device)
                .to(bf16) for _ in range(2))
        out, lse = la.attention_fwd(q, k, v, scale, True)
        gqa = Hkv != H
        ql, kl, vl = (a.detach().requires_grad_(True) for a in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                            enable_gqa=gqa)
        fns = {
            "attention_fwd": (
                lambda: la.attention_fwd(q, k, v, scale, True),
                lambda: la.attention_fwd_plain(q, k, v, scale, True),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=gqa)),
            "attention_bwd": (
                lambda: la.attention_bwd(q, k, v, out, lse, g, scale, True),
                lambda: la.attention_bwd_plain(q, k, v, out, lse, g, scale,
                                               True),
                lambda: torch.autograd.grad(ol, (ql, kl, vl), g,
                                            retain_graph=True))}
        bounds = attention_bounds(B, H, S, D, 2, True, Hkv)
        for (name, (kern, plain, lib)), (bound, by) in zip(fns.items(),
                                                           bounds):
            ms = time_ms(kern, flush, iters=iters)
            plain_ms = time_ms(plain, flush, iters=2, warmup=1)
            lib_ms = time_ms(lib, flush, iters=iters)
            torch.cuda.empty_cache()
            log(f"[kernels] {name} time at {label} [{B}, {H}/{Hkv}, {S}, "
                f"{D}] bf16: kernel {ms:.4f} ms | bound {bound:.4f} ms "
                f"({by}) | plain {plain_ms:.4f} ms | library_ms "
                f"{lib_ms:.4f} ms (SDPA{', enable_gqa' if gqa else ''}"
                f"{'' if name == 'attention_fwd' else ', autograd'}) | "
                f"{100 * bound / ms:.1f}% of bound | {ms / lib_ms:.2f}x "
                f"SDPA")
        del q, k, v, g, out, lse, ql, kl, vl, ol
        torch.cuda.empty_cache()


# -- phase 3c: the int8 serving kernels ----------------------------------------

#: (K, N) of the Llama-2-7B projections: q/k/v/o (32 kv heads), gate/up,
#: down
QMM_SHAPES = {"q/k/v/o_proj": (4096, 4096), "gate/up_proj": (4096, 11008),
              "down_proj": (11008, 4096)}
#: Llama-2-13B's projections (phase 4i's int8 engine): N = 13824 is 108
#: tiles of 128, and K = 13824 the longest reduction
QMM_13B_SHAPES = {"13b q/k/v/o_proj": (5120, 5120),
                  "13b gate/up_proj": (5120, 13824),
                  "13b down_proj": (13824, 5120)}


def quant_matmul_bound(M, K, N, x_bytes):
    """(bound_ms, bound_by): x, the int8 weight, the scales and out moved
    once over HBM rate, against 2MKN flops at x's rate (bf16 tensor cores
    for bf16 x, the fp32 rate for f32 x)."""
    nbytes = M * K * x_bytes + K * N + 4 * N + M * N * x_bytes
    rate = BF16_FLOPS if x_bytes == 2 else FP32_FLOPS
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = 2 * M * K * N / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def quantize_pages(pages):
    """Per-page symmetric int8 of float pools [KV, P, ps, D]: (int8
    pages, f32 scales [KV, P]), amax / 127 as ``kv_write`` settles it."""
    amax = pages.float().abs().amax(dim=(2, 3))
    scales = amax / 127.0
    q = torch.round(pages.float() / torch.where(scales > 0, scales, 1.0)
                    [..., None, None])
    return q.clamp_(-127, 127).to(torch.int8), scales


def make_quant_paged_case(gen, B, KV, G, D, ps, pps, lengths, q_dtype,
                          device):
    """As ``make_paged_case`` over int8 pages: every slot past a
    sequence's cover points at one page whose scales are NaN, so a read
    of it would poison the output; the unwritten tail of each last page
    holds garbage at its page's scale."""
    q, kp, vp, lens, table = make_paged_case(
        gen, B, KV, G, D, ps, pps, lengths, q_dtype, torch.float32, device)
    nan_page = kp.shape[1] - 1
    kp, vp = (torch.nan_to_num(t, nan=3.0) for t in (kp, vp))
    (kq, ks), (vq, vs) = quantize_pages(kp), quantize_pages(vp)
    ks[:, nan_page] = float("nan")
    vs[:, nan_page] = float("nan")
    return q, kq, vq, lens, table, ks, vs


def paged_decode_quant_bound(q, k_pages, lengths, page_indices):
    """(bound_ms, bound_by): the int8 K and V rows under each length, one
    K and one V scale per covered page, the table entries, lengths, q in
    and out, over HBM rate, against the dots (4 flops per query row,
    token and dim) and the dequantizing multiplies (2 per kv head, token
    and dim) over the fp32 rate."""
    B, H, D = q.shape
    KV, _, ps, _ = k_pages.shape
    lens = [int(x) for x in lengths.cpu()]
    tokens = sum(lens)
    pages = sum(-(-n // ps) for n in lens)
    nbytes = (2 * tokens * KV * D + 2 * pages * KV * 4 + pages * 4 + B * 4
              + 2 * q.numel() * q.element_size())
    flops = 4 * tokens * H * D + 2 * tokens * KV * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_quant_kernels(device, iters=50):
    """Both int8 serving kernels against their plain versions at the
    int8 serving path's shapes, then timed.  Returns their rows."""
    from paddle_tpu_torch.ops import quant as tq
    from paddle_tpu_torch.ops.kernels import paged_decode as pdmod
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    gen = torch.Generator(device=device)
    gen.manual_seed(2468)
    f32, bf16 = torch.float32, torch.bfloat16
    before = (qm.quant_matmul.launches, pdmod.paged_decode_quant.launches)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=device)

    # kernel A: every projection shape, decode and prefill M, both x dtypes
    qmm_err, timed = {}, {}
    qm.quant_matmul.routes = dict.fromkeys(qm.ROUTES, 0)

    def hold_qmm(label, M, xs, qw, sc, want_route):
        """One call, which must take ``want_route``, match the plain
        version and give the same bits when repeated."""
        before = dict(qm.quant_matmul.routes)
        got = qm.quant_matmul(xs, qw, sc)
        took = [r for r in qm.ROUTES
                if qm.quant_matmul.routes[r] != before[r]]
        if took != [want_route]:
            raise AssertionError(f"[kernels] quant_matmul {label}: took "
                                 f"{took}, expected {want_route}")
        torch.cuda.synchronize()
        want = qm.quant_matmul_reference(xs, qw, sc)
        if xs.dtype == f32:
            tol = (2e-4, 0.0, "fp32 sums of up to 13824 products "
                   "in other orders, |out| ~ 2")
        else:
            tol = (2e-4, 2 ** -7, BF16_WHY)
        err = _hold(f"quant_matmul {label} x {xs.dtype} ({want_route})",
                    got, want, *tol)
        qmm_err[(M, xs.dtype)] = max(qmm_err.get((M, xs.dtype), 0.0), err)
        if not torch.equal(qm.quant_matmul(xs, qw, sc), got):
            raise AssertionError(f"[kernels] quant_matmul {label}: a second "
                                 "call gave other bits")
        return err

    for label, (K, N) in {**QMM_SHAPES, **QMM_13B_SHAPES}.items():
        w = torch.randn(K, N, generator=gen, device=device) * 0.02
        qw, sc = tq.quantize_per_channel(w)
        sc = sc.reshape(N)
        w_bf16 = tq.dequantize(qw, sc, bf16)      # the library's weight
        del w
        # every shape at decode and prefill M; gate/up also at the GEMV's
        # other row counts, past them, and a prompt's last chunk (188)
        extra = (1, 3, 9, 16, 32, 33, 64, 188) \
            if label == "gate/up_proj" else ()
        for M in (8, 512) + extra:
            x = torch.randn(M, K, generator=gen, device=device)
            for xd in ((bf16, f32) if M in (8, 512) else (bf16,)):
                xs = x.to(xd)
                hold_qmm(f"{label} M={M} K={K} N={N}", M, xs, qw, sc,
                         qm.route(M, K, N, xd))
            if M not in (8, 512):
                continue
            xb = x.to(bf16)
            timed[(label, M)] = (
                [time_ms(f, flush, iters=iters) for f in (
                    lambda: qm.quant_matmul(xb, qw, sc),
                    lambda: qm.quant_matmul_reference(xb, qw, sc),
                    lambda: torch.matmul(xb, w_bf16))],
                quant_matmul_bound(M, K, N, 2), qm.route(M, K, N, bf16))
            del x, xb
        if label == "gate/up_proj":
            # x rows past M, weight rows past K and scales past N hold NaN
            # or garbage in the same allocations: none may reach out
            for M in (9, 188):
                xbig = torch.randn(M + 64, K, generator=gen, device=device)
                xbig[M:] = float("nan")
                wbig = torch.full((K + 64, N), 127, dtype=torch.int8,
                                  device=device)
                wbig[:K] = qw
                sbig = torch.full((N + 64,), float("nan"), device=device)
                sbig[:N] = sc
                hold_qmm(f"{label} M={M} K={K} N={N}, NaN rows past M",
                         M, xbig.to(bf16)[:M], wbig[:K], sbig[:N],
                         qm.route(M, K, N, bf16))
                del xbig, wbig, sbig
        del qw, sc, w_bf16
        torch.cuda.empty_cache()
    # shapes TMA cannot describe take the SIMT kernels (any M, K and N)
    for M, K, N in ((3, 100, 37), (8, 4100, 4096), (77, 300, 130),
                    (188, 4096, 4100)):
        w = torch.randn(K, N, generator=gen, device=device) * 0.02
        qw, sc = tq.quantize_per_channel(w)
        x = torch.randn(M, K, generator=gen, device=device).to(bf16)
        hold_qmm(f"off the TMA rule M={M} K={K} N={N}", M, x, qw,
                 sc.reshape(N), "simt")
    log(f"[kernels] quant_matmul routes over the checks: "
        f"{dict(qm.quant_matmul.routes)}")
    for (label, M), ((ms, plain_ms, lib_ms), (bound, by), kind) in \
            timed.items():
        log(f"[kernels] quant_matmul time at {label} M={M} x bf16 ({kind} "
            f"route): kernel {ms:.4f} ms | bound {bound:.4f} ms ({by}) | "
            f"plain {plain_ms:.4f} ms | library_ms {lib_ms:.4f} ms "
            f"(torch.matmul over the weight dequantized to bf16 "
            f"beforehand) | {100 * bound / ms:.1f}% of bound | "
            f"{ms / lib_ms:.2f}x the library's time")

    # kernel B: int8 pages at the decode shapes of phase 3
    l7b = [1, 8, 2048, 17, 500, 1024, 1999, 333]
    cases = [
        ("llama2-7b serving (q f32, pool int8)",
         dict(B=8, KV=32, G=1, D=128, ps=16, pps=128, lengths=l7b), f32,
         2e-5, 0.0, "fp32 math on the same dequantized values, other "
         "summation order"),
        ("llama2-7b q bf16, pool int8",
         dict(B=8, KV=32, G=1, D=128, ps=16, pps=128, lengths=l7b), bf16,
         1e-4, 2 ** -7, BF16_WHY),
        ("gqa G=4 ps=32", dict(B=4, KV=8, G=4, D=128, ps=32, pps=64,
                               lengths=[2048, 1, 40, 777]), f32, 2e-5, 0.0,
         "fp32 math, other summation order"),
        ("gqa G=2 D=64", dict(B=3, KV=4, G=2, D=64, ps=16, pps=32,
                              lengths=[512, 9, 100]), f32, 2e-5, 0.0,
         "fp32 math, other summation order"),
    ] + [(label, shape, f32, 2e-5, 0.0, "fp32 math on the same dequantized "
          "values, other summation order")
         for label, shape in PAGED_NEW_CASES] + [
        ("MQA G=32 q bf16", dict(PAGED_NEW_CASES[1][1]), bf16, 1e-4,
         2 ** -7, BF16_WHY),
        ("llama2-13b serving (q f32, pool int8)",
         dict(B=8, KV=40, G=1, D=128, ps=16, pps=64, lengths=L13B), f32,
         2e-5, 0.0, "fp32 math on the same dequantized values, other "
         "summation order"),
    ]
    main_case = None
    for label, shape, qd, atol, rtol, why in cases:
        args = make_quant_paged_case(gen, q_dtype=qd, device=device, **shape)
        got = pdmod.paged_decode_quant(*args)
        torch.cuda.synchronize()
        want = pdmod.paged_decode_quant_reference(*args)
        err = _hold(f"paged_decode_quant {label}", got, want, atol, rtol,
                    why)
        if main_case is None:
            main_case = (args, err)
    args, pdq_err = main_case
    q, kq, vq, lens, table, ks, vs = args
    ms = time_ms(lambda: pdmod.paged_decode_quant(*args), flush, iters=iters)
    plain_ms = time_ms(lambda: pdmod.paged_decode_quant_reference(*args),
                       flush, iters=iters)
    B, H, D = q.shape
    T = table.shape[1] * kq.shape[2]
    idx = table.long()

    def dense(pages, scales):
        w = pages[:, idx].float() * scales[:, idx][..., None, None]
        return w.transpose(0, 1).reshape(B, -1, T, D)

    library_ms = _paged_library_ms(q, dense(kq, ks), dense(vq, vs), lens,
                                   flush, iters=iters)
    pdq_bound, pdq_by = paged_decode_quant_bound(q, kq, lens, table)
    log(f"[kernels] paged_decode_quant time at B=8 KV=32 D=128 ps=16 "
        f"pps=128, lengths {l7b}, q f32 / pool int8: kernel {ms:.4f} ms | "
        f"bound {pdq_bound:.4f} ms ({pdq_by}) | plain {plain_ms:.4f} ms | "
        f"library_ms {library_ms:.4f} ms (scaled_dot_product_attention, "
        f"bf16, over the gathered and dequantized cache, gather and "
        f"dequantization excluded) | {100 * pdq_bound / ms:.1f}% of bound | "
        f"{library_ms / ms:.2f}x faster than the library")
    sargs = make_quant_paged_case(gen, q_dtype=f32, device=device,
                                  **PAGED_SERVING)
    s_ms = time_ms(lambda: pdmod.paged_decode_quant(*sargs), flush,
                   iters=iters)
    s_bound, _ = paged_decode_quant_bound(sargs[0], sargs[1], sargs[3],
                                          sargs[4])
    log(f"[kernels] paged_decode_quant time at phase 4d's decode step (B=8, "
        f"every length 522, q f32 / pool int8): kernel {s_ms:.4f} ms | "
        f"bound {s_bound:.4f} ms | {100 * s_bound / s_ms:.1f}% of bound")
    sargs = make_quant_paged_case(gen, q_dtype=f32, device=device,
                                  **PAGED_13B)
    _time_paged_13b("paged_decode_quant", pdmod.paged_decode_quant,
                    pdmod.paged_decode_quant_reference,
                    paged_decode_quant_bound, sargs, flush,
                    (_paged_dense(sargs[0], sargs[4], sargs[1], sargs[5]),
                     _paged_dense(sargs[0], sargs[4], sargs[2], sargs[6])))
    del flush, args, q, kq, vq, sargs
    torch.cuda.empty_cache()
    qm.quant_matmul.launches, pdmod.paged_decode_quant.launches = before
    qm.quant_matmul.routes = dict.fromkeys(qm.ROUTES, 0)

    (qmm_ms, qmm_plain, qmm_lib), (qmm_bound, qmm_by), _ = \
        timed[("gate/up_proj", 8)]
    return [
        {"name": "quant_matmul", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "paddle_tpu/ops/pallas_kernels/quant_matmul.py:85",
         "max_abs_err": max(qmm_err.values()), "ms": qmm_ms,
         "plain_ms": qmm_plain, "bound_ms": qmm_bound, "bound_by": qmm_by,
         "library_ms": qmm_lib},
        {"name": "paged_decode_quant", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_decode.cu",
         "replaces": "paddle_tpu/ops/pallas_kernels/paged_decode.py:240",
         "max_abs_err": pdq_err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": pdq_bound, "bound_by": pdq_by,
         "library_ms": library_ms},
    ]


# -- phase 3v: the serving kernels at serve.verify's shapes -------------------

#: serve.verify at batch 8 and window W = k + 1 = 5 over phase 4b's
#: lengths: B * W query rows, each sequence's table row repeated W times,
#: row (b, w) masked to 523 + w keys
VERIFY_SHAPE = dict(B=8, W=5, KV=32, G=1, D=128, ps=16, pps=128, base=523)


def _verify_case(gen, device, quant):
    """Paged-decode inputs at :data:`VERIFY_SHAPE`: a pool as phase 3's
    (int8 with NaN-scaled tails when ``quant``) over lengths base + W - 1,
    q [B * W, H, D] bf16, the tables repeated W times and the lengths
    base + w per row.  Returns (args, dense caches for SDPA)."""
    v = VERIFY_SHAPE
    B, W = v["B"], v["W"]
    shape = dict(B=B, KV=v["KV"], G=v["G"], D=v["D"], ps=v["ps"],
                 pps=v["pps"], lengths=[v["base"] + W - 1] * B)
    if quant:
        q, kp, vp, _, table, ks, vs = make_quant_paged_case(
            gen, q_dtype=torch.bfloat16, device=device, **shape)
    else:
        q, kp, vp, _, table = make_paged_case(
            gen, q_dtype=torch.bfloat16, kv_dtype=torch.bfloat16,
            device=device, **shape)
    q = torch.randn(B * W, q.shape[1], q.shape[2], generator=gen,
                    device=device).to(torch.bfloat16)
    tables = table.repeat_interleave(W, dim=0).contiguous()
    lens = (v["base"] + torch.arange(W, device=device, dtype=torch.int32)
            ).repeat(B).contiguous()
    args = (q, kp, vp, lens, tables) + ((ks, vs) if quant else ())
    T = table.shape[1] * kp.shape[2]
    idx = table.long()

    def dense(pages, scales=None):
        w = pages[:, idx].float()
        if scales is not None:
            w = w * scales[:, idx][..., None, None]
        return w.transpose(0, 1).reshape(B, -1, T, v["D"])

    dk = dense(kp, ks if quant else None)
    dv = dense(vp, vs if quant else None)
    return args, (dk, dv)


def _verify_bounds(args, quant):
    """(once_ms, w_times_ms): the bytes bound of the verify-shaped call
    with each sequence's K/V rows read once (under its longest row's
    length) and read once per window row, as the kernel reads them."""
    v = VERIFY_SHAPE
    B, W, KV, D, ps = v["B"], v["W"], v["KV"], v["D"], v["ps"]
    q = args[0]
    elem = 1 if quant else 2
    rows = [int(x) for x in args[3].cpu()]
    once = [max(rows[b * W:(b + 1) * W]) for b in range(B)]

    def nbytes(lens):
        pages = sum(-(-n // ps) for n in lens)
        extra = 2 * pages * KV * 4 if quant else 0
        return (2 * sum(lens) * KV * D * elem + extra + pages * 4
                + len(rows) * 4 + 2 * q.numel() * q.element_size())

    return tuple(nbytes(x) / HBM_BYTES_PER_S * 1e3 for x in (once, rows))


def phase_verify_kernels(device, iters=50):
    """Phase 3v: paged decode (bf16 and int8 pools) at serve.verify's
    shape and the int8-weight matmul at verify's M = B * W = 40 rows,
    each against its plain version, then timed beside its bound(s), the
    plain version and the library call.  Launches here are not counted."""
    from paddle_tpu_torch.ops import quant as tq
    from paddle_tpu_torch.ops.kernels import paged_decode as pdmod
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    gen = torch.Generator(device=device)
    gen.manual_seed(1357)
    before = (pdmod.paged_decode.launches, pdmod.paged_decode_quant.launches,
              qm.quant_matmul.launches, dict(qm.quant_matmul.routes))
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=device)
    v = VERIFY_SHAPE
    B, W = v["B"], v["W"]
    F = torch.nn.functional
    for quant in (False, True):
        fn = pdmod.paged_decode_quant if quant else pdmod.paged_decode
        ref = (pdmod.paged_decode_quant_reference if quant
               else pdmod.paged_decode_reference)
        name = fn.__name__
        args, (dk, dv) = _verify_case(gen, device, quant)
        got = fn(*args)
        torch.cuda.synchronize()
        _hold(f"{name} at verify's shape (B={B} x W={W} rows, tables "
              f"repeated, lengths {v['base']}+w)", got, ref(*args), 1e-4,
              2 ** -7, BF16_WHY)
        ms = time_ms(lambda: fn(*args), flush, iters=iters)
        plain_ms = time_ms(lambda: ref(*args), flush, iters=iters)
        # the library: SDPA over each sequence's gathered cache with its W
        # query rows and the in-window causal mask
        T = dk.shape[2]
        lens = args[3].view(B, W)
        mask = (torch.arange(T, device=device)[None, None]
                < lens[:, :, None])[:, None]               # [B, 1, W, T]
        qs = args[0].view(B, W, -1, v["D"]).transpose(1, 2)
        kd, vd = (torch.where(mask[:, :, -1, :, None], t, 0)
                  .to(torch.bfloat16) for t in (dk, dv))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, kd, vd, attn_mask=mask), flush, iters=iters)
        once, wtimes = _verify_bounds(args, quant)
        log(f"[kernels] {name} time at verify's shape (q bf16, pool "
            f"{'int8' if quant else 'bf16'}, {B * W} rows): kernel "
            f"{ms:.4f} ms | bound {once:.4f} ms with each sequence's pages "
            f"read once, {wtimes:.4f} ms read W = {W} times (bytes) | "
            f"plain {plain_ms:.4f} ms | library_ms {lib_ms:.4f} ms "
            f"(scaled_dot_product_attention, bf16, {W} query rows a "
            f"sequence over its gathered"
            f"{' and dequantized' if quant else ''} cache, in-window causal "
            f"mask) | {100 * once / ms:.1f}% of the read-once bound, "
            f"{100 * wtimes / ms:.1f}% of the W-times bound | "
            f"{lib_ms / ms:.2f}x faster than the library")
        del args, dk, dv, kd, vd
    # the int8-weight matmul at verify's M on the 7B gate/up shape
    K, N = QMM_SHAPES["gate/up_proj"]
    M = B * W
    w = torch.randn(K, N, generator=gen, device=device) * 0.02
    qw, sc = tq.quantize_per_channel(w)
    sc = sc.reshape(N)
    w_bf16 = tq.dequantize(qw, sc, torch.bfloat16)
    del w
    x = torch.randn(M, K, generator=gen, device=device).to(torch.bfloat16)
    kind = qm.route(M, K, N, torch.bfloat16)
    seen = dict(qm.quant_matmul.routes)
    got = qm.quant_matmul(x, qw, sc)
    took = [r for r in qm.ROUTES if qm.quant_matmul.routes[r] != seen[r]]
    torch.cuda.synchronize()
    if took != [kind]:
        raise AssertionError(f"[kernels] quant_matmul M={M}: took {took}, "
                             f"expected {kind}")
    _hold(f"quant_matmul gate/up_proj M={M} K={K} N={N} x bf16 ({kind})",
          got, qm.quant_matmul_reference(x, qw, sc), 2e-4, 2 ** -7, BF16_WHY)
    ms, plain_ms, lib_ms = (time_ms(f, flush, iters=iters) for f in (
        lambda: qm.quant_matmul(x, qw, sc),
        lambda: qm.quant_matmul_reference(x, qw, sc),
        lambda: torch.matmul(x, w_bf16)))
    bound, by = quant_matmul_bound(M, K, N, 2)
    log(f"[kernels] quant_matmul time at gate/up_proj M={M} (verify's "
        f"B={B} x W={W}) x bf16 ({kind} route): kernel {ms:.4f} ms | bound "
        f"{bound:.4f} ms ({by}) | plain {plain_ms:.4f} ms | library_ms "
        f"{lib_ms:.4f} ms (torch.matmul over the weight dequantized to "
        f"bf16 beforehand) | {100 * bound / ms:.1f}% of bound | "
        f"{ms / lib_ms:.2f}x the library's time")
    del flush, qw, sc, w_bf16, x
    torch.cuda.empty_cache()
    (pdmod.paged_decode.launches, pdmod.paged_decode_quant.launches,
     qm.quant_matmul.launches) = before[:3]
    qm.quant_matmul.routes = before[3]


# -- phase 4 -----------------------------------------------------------------

SERVE_KW = dict(max_seqs=8, page_size=16, max_len=2048, prefill_chunk=512)
#: 8 requests of 16-32 new tokens (16 of 32-64 before the time cut):
#: the same load as the durable-serving worker's ``7b`` setup (phase 4g)
SERVE_LOAD = dict(n_requests=8, mean_interarrival=2.0,
                  prompt_len=(128, 1024), max_new=(16, 32), vocab=32000,
                  seed=0)


def _serve_counters():
    from paddle_tpu_torch.ops.kernels import paged_decode as pdmod
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    return {"paged_decode": pdmod.paged_decode,
            "paged_decode_quant": pdmod.paged_decode_quant,
            "quant_matmul": qm.quant_matmul}


def _streams(out):
    return {rid: list(h.tokens) for rid, h in out["handles"].items()}


def _first_diff(got, want):
    """(rid, token index) of the first difference of two stream dicts."""
    for rid in sorted(want):
        a, b = got.get(rid, []), want[rid]
        for i in range(max(len(a), len(b))):
            if i >= len(a) or i >= len(b) or a[i] != b[i]:
                return rid, i
    return None


def _run_audited(engine, work):
    """``run_load`` with ``check_pool_invariants`` after every step (its
    host seconds summed apart, so they can be told from the serving
    time).  Returns run_load's dict plus ``audit_s``."""
    from paddle_tpu_torch.inference.server import check_pool_invariants

    pending = sorted(work, key=lambda w: (w["arrival_tick"], w["rid"]))
    handles, audit = {}, 0.0
    while pending or engine.in_flight:
        if engine.tick >= 10000:
            raise RuntimeError("load did not drain in 10000 steps")
        while pending and pending[0]["arrival_tick"] <= engine.tick:
            w = pending.pop(0)
            handles[w["rid"]] = engine.submit(
                w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
                priority=w["priority"], rid=w["rid"])
        engine.step()
        t0 = time.perf_counter()
        check_pool_invariants(engine.executor.cache, engine.prefix)
        audit += time.perf_counter() - t0
    return {"handles": handles, "stats": engine.stats(), "audit_s": audit}


def phase_serve(device, cfg=None, load=None, dtype=torch.bfloat16,
                engine_kw=None, quant="none", eager=False, tag=None,
                audit=False, precapture=False, params_fn=None):
    """Serve ``load`` through a ServingEngine built on seeded weights (or
    on those ``params_fn()`` returns: the caller keeps no reference, so
    an int8 engine's dense projections are freed once quantized).
    ``eager`` runs decode's forward op by op (the executor's private A/B
    switch); else decode replays CUDA graphs, captured at each new batch
    or, with ``aot`` in ``engine_kw``, at build (with ``eager``, aot only
    arms the prefill ladder: no graph would be replayed).  ``audit``
    checks the page pool's invariants after every step; ``precapture``
    captures the decode step (the verify step with spec on) at every
    batch before the load, so no capture falls inside a TTFT or TPOT.
    Returns ({kernel: launches in the run}, engine, {rid: tokens})."""
    from paddle_tpu_torch.inference.server import RequestState, ServingEngine
    from paddle_tpu_torch.models import LlamaConfig, init_llama_params
    from paddle_tpu_torch.testing.load import (
        LoadSpec, generate_load, run_load,
    )

    cfg = LlamaConfig.llama2_7b() if cfg is None else cfg
    load = SERVE_LOAD if load is None else load
    engine_kw = SERVE_KW if engine_kw is None else engine_kw
    if tag is None:
        tag = ("serve" if quant == "none" else f"serve-{quant}") \
            + (" eager" if eager else " graph")
    t0 = time.perf_counter()
    params = (init_llama_params(cfg, seed=0, device=device, dtype=dtype)
              if params_fn is None else params_fn())
    nparams = (sum(t.numel() for t in params["layers"].values())
               + params["embed"].numel()
               + (0 if params["lm_head"] is None
                  else params["lm_head"].numel()))
    ladder_only = eager and engine_kw.get("aot", "off") != "off"
    engine = ServingEngine(cfg, params, dtype=dtype, device=device,
                           quant=quant, **dict(
                               engine_kw, **({"aot": "off"} if ladder_only
                                             else {})))
    del params          # an int8 engine keeps no dense projection
    ex = engine.executor
    ex._eager_decode = eager
    if ladder_only:     # the warm engines' ladder and page buckets
        ex.arm_ladder(engine_kw["prefill_chunk"])
        log(f"[{tag}] decode eager: prefill ladder {ex.aot_ladder.rungs} "
            f"and page buckets {ex._aot_page_buckets} armed, no graph "
            f"captured")
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2**30
    else:
        resident = float("nan")
    log(f"[{tag}] {cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, D "
        f"{cfg.head_dim}, intermediate {cfg.intermediate_size}, vocab "
        f"{cfg.vocab_size}: {nparams / 1e9:.3f} B parameters in {dtype}, "
        f"quant={quant}, aot={engine.aot_mode}, built in "
        f"{time.perf_counter() - t0:.1f} s; {resident:.2f} GiB resident "
        f"(weights, KV pool and any warmed graphs)")
    rep = engine._aot_report
    if rep is not None:
        log(f"[{tag}] warmup: {rep['entries']} entries, {rep['capture']} "
            f"captured, {rep['warm']} warm, {len(rep['failed'])} failed, "
            f"{rep['seconds']} s; programs {rep['programs']}; ladder "
            f"{rep['ladder']}; page buckets {rep['page_buckets']}")
        if rep["failed"]:
            raise AssertionError(f"[{tag}] warmup entries failed: "
                                 f"{rep['failed']}")
    progs = ex.programs
    if precapture:
        spec = engine.spec
        for B in range(1, ex.cache.max_seqs + 1):
            if spec is None:
                progs["decode"].aot_capture((B,))
            else:
                progs["verify"].aot_capture((B, spec.k + 1))
    before = {k: (p.traces, p.dispatches, p.seconds)
              for k, p in progs.items()}
    work = generate_load(LoadSpec(**dict(load, vocab=cfg.vocab_size)))
    counters = _serve_counters()
    for f in counters.values():
        f.launches = 0
    qmm = counters["quant_matmul"]
    qmm.routes = dict.fromkeys(qmm.routes, 0)
    ex.prefill_events.clear()
    t0 = time.perf_counter()
    out = _run_audited(engine, work) if audit else run_load(engine, work)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine.audit_s = out.get("audit_s", 0.0)
    got = {k: f.launches for k, f in counters.items()}
    st = out["stats"]
    for w in work:
        h = out["handles"][w["rid"]]
        toks = h.tokens
        if h.state is not RequestState.FINISHED \
                or len(toks) != w["max_new_tokens"] \
                or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(
                f"[{tag}] {w['rid']}: {h.state.value}, {len(toks)} of "
                f"{w['max_new_tokens']} tokens")
    # a decode step is one serve.decode call, or with spec one
    # serve.verify call: either runs each kernel once per layer
    L, steps = cfg.num_hidden_layers, st["decode_steps"]
    forwards = len(ex.prefill_events)
    kind = "verify" if engine.spec is not None else "decode"
    if quant == "int8":
        want = {"paged_decode": 0, "paged_decode_quant": L * steps,
                "quant_matmul": 7 * L * (steps + forwards)}
        rule = (f"paged_decode_quant {L} layers x {steps} {kind} steps; "
                f"quant_matmul 7 x {L} layers x ({steps} {kind} steps + "
                f"{forwards} prefill forwards); paged_decode 0")
    else:
        want = {"paged_decode": L * steps, "paged_decode_quant": 0,
                "quant_matmul": 0}
        rule = f"paged_decode {L} layers x {steps} {kind} steps"
    if device.type == "cuda" and got != want:
        raise AssertionError(f"[{tag}] launches {got}, expected {want} "
                             f"({rule})")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else float("nan"))
    log(f"[{tag}] {len(work)} requests finished in {wall:.3f} s, "
        f"{st['steps']} steps, {steps} {kind} steps, {forwards} prefill "
        f"forwards, {st['decode_tokens']} decode tokens, "
        f"{st['prefill_tokens']} prefill tokens, {st['preemptions']} "
        f"preemptions | {st['decode_tokens'] / wall:.2f} decode tok/s | "
        f"TTFT p50 {st['ttft_ms_p50']} ms p99 {st['ttft_ms_p99']} ms | "
        f"TPOT p50 {st['tpot_ms_p50']} ms p99 {st['tpot_ms_p99']} ms | "
        f"launches {got} ({rule}) | peak memory {peak:.2f} GiB")
    d = {k: (p.traces - before[k][0], p.dispatches - before[k][1],
             p.seconds - before[k][2]) for k, p in progs.items()}
    log(f"[{tag}] programs in the run: " + "; ".join(
        f"serve.{k} {n} captured in {sec:.3f} s, {r} "
        + ("eager calls" if device.type != "cuda" else "replays")
        for k, (n, r, sec) in d.items())
        + (" (decode eager: no program called)" if eager else ""))
    if eager and any(r for _, r, _ in d.values()):
        raise AssertionError(f"[{tag}] the eager A/B ran a program: {d}")
    if not eager and d[kind][1] != steps:
        raise AssertionError(f"[{tag}] {d[kind][1]} serve.{kind} "
                             f"calls for {steps} {kind} steps")
    if quant == "int8":
        log(f"[{tag}] quant_matmul calls by route: {dict(qmm.routes)}")
    return got, engine, _streams(out)


def _live_pools(engine):
    """The KV pool (and int8 scales) without the scratch page, on the
    host: what a load wrote, to hold two runs bit for bit."""
    c = engine.executor.cache
    ts = [c.k_pages, c.v_pages]
    if c.k_scales is not None:
        ts += [c.k_scales, c.v_scales]
    return [t.cpu() for t in ts]


def phase_serve_ab(device, quant="none", **kw):
    """Phases 4 / 4c with 4b / 4d: the load served with decode eager,
    then as replayed graphs, each followed by its decode profile.  The
    greedy streams and the KV pools the load wrote must be identical.
    Returns (launches of the graph run, its streams)."""
    _, engine, want = phase_serve(device, quant=quant, eager=True, **kw)
    pools = _live_pools(engine)
    if device.type == "cuda":
        phase_profile(engine, device)
    del engine
    _empty(device)
    got, engine, streams = phase_serve(device, quant=quant, **kw)
    tag = "serve" if quant == "none" else f"serve-{quant}"
    if streams != want:
        raise AssertionError(f"[{tag}] graph decode streams differ from "
                             f"eager at {_first_diff(streams, want)}")
    same = all(torch.equal(a, b) for a, b in zip(_live_pools(engine), pools))
    if not same:
        raise AssertionError(f"[{tag}] the KV pools of the graph and eager "
                             f"runs differ")
    log(f"[{tag}] graph decode = eager decode: identical greedy streams "
        f"({sum(map(len, streams.values()))} tokens) and KV pools bit for "
        f"bit")
    del pools
    if device.type == "cuda":
        phase_profile(engine, device)
    del engine
    _empty(device)
    return got, streams


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _empty(device):
    gc.collect()         # an executor and its graphs form a cycle
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def phase_profile(engine, device, n_steps=5, prompt=512, label=None):
    """Where a decode step's time goes: fill every slot with a
    ``prompt``-token request, then time ``n_steps`` decode-only steps on
    the host clock (synchronised) and trace ``n_steps`` more with
    torch.profiler, summing device kernel time by kind.  With spec on a
    decode step is a verify step (serve.verify at the window k + 1)."""
    from torch.profiler import ProfilerActivity, profile

    ex = engine.executor
    cfg = ex.config
    rng = np.random.RandomState(7)
    handles = [engine.submit(rng.randint(1, cfg.vocab_size, prompt),
                             max_new_tokens=4 * n_steps + 4)
               for _ in range(ex.cache.max_seqs)]
    while engine.scheduler.queue or engine.scheduler.prefilling:
        engine.step()
    engine.step()          # the first step at batch 8 may capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    step_kind = "verify" if engine.spec is not None else "decode"
    decode = ex.programs[step_kind]
    replays = decode.dispatches
    # the device activity alone: nothing below reads the host's events
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / n_steps * 1e3
    replays = decode.dispatches - replays
    # kinds by kernel name, first match wins
    patterns = (("quant_matmul", ("qmm_",)),
                ("paged_decode_quant", ("paged_decode_quant",)),
                ("paged_decode", ("paged_decode",)),
                ("gemm", ("gemm", "cutlass", "xmma", "nvjet")))
    kinds = {k: 0.0 for k, _ in patterns}
    kinds["other"] = 0.0
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3 / n_steps
        name = ev.key.lower()
        kind = next((k for k, pats in patterns
                     if any(p in name for p in pats)), "other")
        kinds[kind] += ms
        per_kernel[ev.key[:60]] = (ms, ev.count / n_steps)
    busy = sum(kinds.values())

    def nbytes(w):
        if isinstance(w, dict):
            return sum(nbytes(t) for t in w.values())
        return w.numel() * w.element_size()

    weight_bytes = sum(nbytes(w) for w in ex.layers.values()) \
        + nbytes(ex.tops["head_w"])
    lens = [int(ex.cache.lengths[h._req.sid]) for h in handles]
    mode = "eager" if ex._eager_decode else "graph"
    tag = (label or ("profile" if ex.quant == "none"
                     else f"profile-{ex.quant}")) + f" {mode}"
    if mode == "graph" and (replays != n_steps or not busy):
        raise AssertionError(
            f"[{tag}] {replays} replays in {n_steps} traced steps, "
            f"{busy:.3f} ms of device time attributed to them")
    log(f"[{tag}] {step_kind} step at batch {len(handles)}, lengths "
        f"{min(lens)}-{max(lens)}: {step_ms:.3f} ms untraced, "
        f"{traced_ms:.3f} ms traced | device busy {busy:.3f} ms/step ("
        + ", ".join(f"{k} {v:.3f}" for k, v in kinds.items() if v or
                    k in ("gemm", "other"))
        + f") | idle share {1 - busy / traced_ms:.3f} (of the untraced "
        f"step {max(0.0, 1 - busy / step_ms):.3f}) | {replays} graph "
        f"replays traced | weight-read bound "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms/step "
        f"({weight_bytes / 1e9:.3f} GB of layer and head weights)")
    if ex.quant == "int8":
        log(f"[{tag}] int8 weight GEMMs: quant_matmul (qmm_ kernels) "
            f"{kinds['quant_matmul']:.3f} ms/step, cuBLAS (the bf16 LM "
            f"head) {kinds['gemm']:.3f} ms/step")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, calls) in top:
        log(f"[{tag}]   {ms:8.3f} ms/step  {calls:6.1f} launches/step  "
            f"{name}")
    for h in handles:
        h.cancel()
    engine.step()


# -- phase 4e: the AOT plane -------------------------------------------------

def _fill_slots(engine, prompts, max_new):
    """Admit one request per prompt and step until every prefill is done;
    returns the handles (their slots decode next)."""
    handles = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    while engine.scheduler.queue or engine.scheduler.prefilling:
        engine.step()
    return handles


def _drain(engine, handles):
    for h in handles:
        h.cancel()
    engine.step()


def _agreement(got, want):
    """(requests whose streams are equal, tokens before each request's
    first difference, tokens in all)."""
    same = lead = 0
    for rid, b in want.items():
        a = got[rid]
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        lead += n
        same += a == b
    return same, lead, sum(map(len, want.values()))


def phase_aot(device, phase4, cfg=None, load=None, dtype=torch.bfloat16,
              engine_kw=None, n=8, rounds=2, prompt=512):
    """Phase 4e: engines with aot="warm" and aot="strict" (decode at every
    batch and decode_n at n captured at build) serve phase 4's load with
    no failed warmup entry.  The ladder floors prefill chunks onto powers
    of two, so a prompt is prefilled in other chunks than in phase 4:
    the streams must equal those of an engine with the same ladder and
    decode eager (the graphs change nothing), and their agreement with
    phase 4's streams ``phase4`` is reported.  After seal(), a rung with
    no graph raises AotMissError.  Then every slot of both engines holds
    the same ``prompt``-token request, and ``rounds`` times the warm
    engine takes n decode steps while the strict one takes one
    decode_n(n): the same tokens, each timed."""
    from paddle_tpu_torch.core.aot import AotMissError

    engine_kw = SERVE_KW if engine_kw is None else engine_kw
    kw = dict(engine_kw, aot="warm", decode_n_steps=(n,))
    _, eng, want = phase_serve(device, cfg=cfg, load=load, dtype=dtype,
                               tag="aot-warm eager", engine_kw=kw,
                               eager=True)
    del eng
    _empty(device)
    same, lead, total = _agreement(want, phase4)
    log(f"[aot] ladder-chunked prefill vs phase 4's chunks, decode eager: "
        f"{same} of {len(phase4)} streams equal, {lead} of {total} tokens "
        f"before each stream's first difference (other chunk lengths, so "
        f"other GEMM shapes and bf16 rounding in the prefill)")
    engines = {}
    for mode in ("warm", "strict"):
        _, eng, streams = phase_serve(
            device, cfg=cfg, load=load, dtype=dtype, tag=f"aot-{mode}",
            engine_kw=dict(kw, aot=mode))
        if streams != want:
            raise AssertionError(
                f"[aot-{mode}] streams differ from the eager run with the "
                f"same ladder at {_first_diff(streams, want)}")
        log(f"[aot-{mode}] greedy streams identical to the eager run with "
            f"the same ladder ({sum(map(len, want.values()))} tokens)")
        engines[mode] = eng
    ex = engines["strict"].executor
    ms = ex.cache.max_seqs
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, ex.config.vocab_size, prompt)
               for _ in range(ms)]
    hs = {m: _fill_slots(e, prompts, rounds * n + 4)
          for m, e in engines.items()}
    sids = {m: sorted(h._req.sid for h in hs[m]) for m in engines}
    for rung, call in (((ms + 1,), lambda: ex.programs["decode"]((ms + 1,))),
                       ((ms, n + 1), lambda: ex.decode_n(sids["strict"],
                                                         n + 1))):
        try:
            call()
        except AotMissError as e:
            log(f"[aot-strict] sealed: rung {rung} raised AotMissError "
                f"({str(e)[:80]}...)")
        else:
            raise AssertionError(f"[aot-strict] rung {rung} ran after "
                                 f"seal()")
    warm = engines["warm"].executor
    states = {m: ({s: engines[m].executor.last_token[s] for s in sids[m]},
                  engines[m].executor.cache.lengths[sids[m]].tolist())
              for m in engines}
    if states["warm"][1] != states["strict"][1] or \
            list(states["warm"][0].values()) != \
            list(states["strict"][0].values()):
        raise AssertionError(f"[aot] the two engines' slots differ before "
                             f"decode_n: {states}")
    t_dec, t_n = [], []
    for _ in range(rounds):
        _sync(device)
        t0 = time.perf_counter()
        steps = [warm.decode(sids["warm"]) for _ in range(n)]
        _sync(device)
        t_dec.append((time.perf_counter() - t0) / n * 1e3)
        t0 = time.perf_counter()
        got = ex.decode_n(sids["strict"], n)
        _sync(device)
        t_n.append((time.perf_counter() - t0) / n * 1e3)
        dec = [[st[s] for st in steps] for s in sids["warm"]]
        if [got[s] for s in sids["strict"]] != dec:
            raise AssertionError(f"[aot] decode_n({n}) differs from {n} "
                                 f"decode steps: {got} vs {dec}")
    log(f"[aot] decode_n({n}) at batch {ms} = {n} decode steps over "
        f"{rounds} rounds ({rounds * n * ms} tokens, lengths "
        f"{prompt + 1}-{prompt + rounds * n}): ms per step "
        f"{', '.join(f'{t:.3f}' for t in t_n)} (decode_n) vs "
        f"{', '.join(f'{t:.3f}' for t in t_dec)} (decode), host wall, "
        f"synchronised")
    for m, e in engines.items():
        _drain(e, hs[m])
    del engines, ex, warm
    _empty(device)


# -- phase 4f: prefix cache, speculative decode, async ----------------------

#: 4f's loads: phase 4's shape at prompts of 128-512 tokens, with a 60%
#: share of requests behind one of two 512-token system prompts (a), and
#: with 75% of the prompts tiled from their first 4 tokens (b)
FEATURE_LOAD = dict(n_requests=8, mean_interarrival=2.0,
                    prompt_len=(128, 512), max_new=(16, 32), vocab=32000,
                    seed=0)
PREFIX_LOAD = dict(FEATURE_LOAD, prefix_share=0.6, prefix_len=512,
                   prefix_pool=2)
REPEAT_LOAD = dict(FEATURE_LOAD, repeat_share=0.75, repeat_period=4)
#: the pool of 4f's eviction leg: room for the running set's pages, not
#: for the running set and every prompt the tree has published
EVICT_PAGES = 160


def _feature_line(tag, engine):
    """One line of a 4f leg's serving and feature numbers."""
    st = engine.stats()
    sch, c = engine.scheduler, engine.executor.cache
    log(f"[{tag}] prefix hit rate {st['prefix_hit_rate']} "
        f"({st['cached_tokens']} cached / {st['prefill_tokens']} prefilled "
        f"tokens), cow_count {c.cow_count}, evicted_pages "
        f"{st['evicted_pages']}, preemptions {st['preemptions']} | "
        f"{st['decode_steps']} decode steps, {st['decode_tokens']} decode "
        f"tokens, tokens per decode step {st['tokens_per_decode_step']}, "
        f"draft acceptance {st['draft_acceptance_rate']} | "
        f"{st['throughput_tok_s']:.2f} decode tok/s | TTFT p50 "
        f"{st['ttft_ms_p50']} ms p99 {st['ttft_ms_p99']} ms "
        f"({st['ttft_steps_p50']} steps) | TPOT p50 "
        f"{st['tpot_ms_p50']} ms p99 {st['tpot_ms_p99']} ms | "
        f"host_overlap_ratio {sch.host_overlap_ratio:.4f}, replans "
        f"{sch.replans} | pool audit "
        f"{1e3 * engine.audit_s / max(st['steps'], 1):.3f} ms a step")
    return st


def _report_agreement(tag, got, want, what):
    same, lead, total = _agreement(got, want)
    log(f"[{tag}] {what}: {same} of {len(want)} streams equal, {lead} of "
        f"{total} tokens before each stream's first difference (reported, "
        f"not gated: bf16 rounding moves with the batch shapes)")


def phase_features(device, phase4, cfg=None, dtype=torch.bfloat16,
                   engine_kw=None, loads=None, evict_pages=EVICT_PAGES,
                   profile=True):
    """Phase 4f at phase 4's engine shape, every leg with the page pool's
    invariants checked after every step and every request finished:
    (a) the prefix cache on vs off on :data:`PREFIX_LOAD`, bf16 and int8,
    and on a pool of ``evict_pages`` pages, where the tree must evict;
    (b) n-gram speculative decode (k = 4) vs off on :data:`REPEAT_LOAD`,
    bf16 and int8, with the verify step profiled; (c) async vs sync on
    phase 4's load, in turns, each profiled: every run must give phase
    4's streams ``phase4``; and async with spec those of the sync spec
    engine (both aot="strict": no failed warmup entry, no capture after
    seal()).
    Returns {kernel: launches under serve.verify replays}."""
    engine_kw = SERVE_KW if engine_kw is None else engine_kw
    loads = loads or {}
    prefix_load = loads.get("prefix", PREFIX_LOAD)
    repeat_load = loads.get("repeat", REPEAT_LOAD)
    serve_load = loads.get("serve", SERVE_LOAD)

    def leg(tag, load, quant="none", **kw):
        got, eng, streams = phase_serve(
            device, cfg=cfg, load=load, dtype=dtype, quant=quant, tag=tag,
            engine_kw=dict(engine_kw, **kw), audit=True, precapture=True)
        st = _feature_line(tag, eng)
        return got, eng, streams, st

    # (a) the prefix cache, off then on
    for quant in ("none", "int8"):
        sfx = "" if quant == "none" else "-int8"
        runs = {"off": [], "on": []}
        for mode in ("off", "on"):
            _, eng, streams, st = leg(f"4f-prefix-{mode}{sfx}", prefix_load,
                                      quant, prefix_cache=mode == "on")
            if mode == "on" and st["cached_tokens"] <= 0:
                raise AssertionError(f"[4f-prefix-on{sfx}] no prefix hit")
            runs[mode].append((streams, st))
            del eng
            _empty(device)
        (off, st_off), (on, st_on) = runs["off"][0], runs["on"][0]
        _report_agreement(f"4f-prefix{sfx}", on, off, "prefix on vs off")

        def ttft(mode, key):
            return ", ".join(str(st[key]) for _, st in runs[mode])

        log(f"[4f-prefix{sfx}] TTFT p50 off {ttft('off', 'ttft_ms_p50')} "
            f"ms, on {ttft('on', 'ttft_ms_p50')} ms ("
            f"{st_off['ttft_steps_p50']} -> {st_on['ttft_steps_p50']} "
            f"steps); p99 off {ttft('off', 'ttft_ms_p99')}, on "
            f"{ttft('on', 'ttft_ms_p99')} ms at hit rate "
            f"{st_on['prefix_hit_rate']}; prefill tokens "
            f"{st_off['prefill_tokens']} -> {st_on['prefill_tokens']}")
    t_ev = time.perf_counter()
    _, eng, ev, st_ev = leg("4f-prefix-evict", prefix_load,
                            prefix_cache=True, num_pages=evict_pages)
    if st_ev["evicted_pages"] <= 0:
        raise AssertionError(f"[4f-prefix-evict] {evict_pages} pages and "
                             f"nothing was evicted")
    _report_agreement("4f-prefix-evict", ev, on, f"{evict_pages}-page pool "
                      f"vs the full pool, prefix on")
    del eng
    _empty(device)
    log(f"[4f-prefix-evict] leg {time.perf_counter() - t_ev:.1f} s")

    # (b) speculative decode
    verify_launches = {}
    for quant in ("none", "int8"):
        sfx = "" if quant == "none" else "-int8"
        _, eng, off, st_off = leg(f"4f-spec-off{sfx}", repeat_load, quant,
                                  spec_decode="off")
        if profile and device.type == "cuda":
            phase_profile(eng, device, label=f"profile-4f-decode{sfx}")
        del eng
        _empty(device)
        got, eng, on, st_on = leg(f"4f-spec-ngram{sfx}", repeat_load, quant,
                                  spec_decode="ngram")
        ex = eng.executor
        L = ex.config.num_hidden_layers
        replays = st_on["decode_steps"]
        if ex.verify_dispatches != replays or replays <= 0:
            raise AssertionError(f"[4f-spec{sfx}] {ex.verify_dispatches} "
                                 f"serve.verify calls for {replays} steps")
        pd = "paged_decode_quant" if quant == "int8" else "paged_decode"
        verify_launches[pd] = L * replays
        if quant == "int8":
            verify_launches["quant_matmul"] = 7 * L * replays
        log(f"[4f-spec{sfx}] launches in the run {got}: {pd} "
            f"{L * replays} = {L} layers x {replays} serve.verify replays"
            + (f", quant_matmul {7 * L * replays} of them under the "
               f"replays (7 x {L} x {replays}), the rest in "
               f"{len(ex.prefill_events)} prefill forwards"
               if quant == "int8" else "")
            + f"; serve.verify captured at "
            f"{sorted(ex.programs['verify']._exe)}")
        _report_agreement(f"4f-spec{sfx}", on, off, "spec ngram vs off")
        if profile and device.type == "cuda":
            phase_profile(eng, device, label=f"profile-4f-verify{sfx}")
        del eng, ex
        _empty(device)

    # (c) async vs sync: each must give phase 4's streams
    for i, mode in enumerate(("sync", "async")):
        tag = f"4f-{mode}-{i}"
        _, eng, got, _ = leg(tag, serve_load, async_exec=mode == "async")
        if got != phase4:
            raise AssertionError(f"[{tag}] streams differ from phase 4's "
                                 f"at {_first_diff(got, phase4)}")
        log(f"[{tag}] phase 4's greedy streams token for token "
            f"({sum(map(len, got.values()))} tokens); phase seconds "
            f"{ {k: round(v, 4) for k, v in eng.scheduler.phase_totals.items()} }")
        if profile and device.type == "cuda":
            phase_profile(eng, device, label=f"profile-{tag}")
        del eng
        _empty(device)
    runs = {}
    for name, kw in (("sync", {}), ("async", dict(async_exec=True))):
        _, eng, runs[name], _ = leg(f"4f-spec-strict-{name}", serve_load,
                                    spec_decode="ngram", aot="strict", **kw)
        ex = eng.executor
        rep = eng._aot_report
        verify = ex.programs["verify"]
        if rep["failed"] or rep["programs"].get("serve.verify") != \
                ex.cache.max_seqs:
            raise AssertionError(f"[4f-spec-strict-{name}] warmup {rep}")
        captured = sum(p.traces for p in ex.programs.values())
        if captured != rep["capture"]:
            raise AssertionError(
                f"[4f-spec-strict-{name}] {captured - rep['capture']} "
                f"captures after seal()")
        log(f"[4f-spec-strict-{name}] warmup captured {rep['capture']} "
            f"graphs ({rep['programs']}) in {rep['seconds']} s, none failed; "
            f"{verify.dispatches} serve.verify replays and no capture after "
            f"seal()")
        del eng, ex, verify
        _empty(device)
    if runs["async"] != runs["sync"]:
        raise AssertionError(
            f"[4f-spec-strict] async spec streams differ from sync at "
            f"{_first_diff(runs['async'], runs['sync'])}")
    log(f"[4f-spec-strict] async = sync with spec on: identical greedy "
        f"streams ({sum(map(len, runs['sync'].values()))} tokens)")
    _report_agreement("4f-spec-strict", runs["sync"], phase4,
                      "spec (ladder-chunked prefill) vs phase 4")
    return verify_launches


# -- phase 5 -----------------------------------------------------------------

PARITY_KW = dict(max_seqs=4, page_size=16, max_len=256, prefill_chunk=32)
#: 5b and 5c keep their own loads
PARITY_LOAD = dict(n_requests=4, mean_interarrival=1.0,
                   prompt_len=(16, 64), max_new=(8, 8), vocab=32000,
                   seed=1)


def phase_parity(device, cfg=None, quant="none"):
    from paddle_tpu_torch.inference.server import PagedExecutor, ServingEngine
    from paddle_tpu_torch.models import (
        LlamaConfig, init_llama_params, params_to,
    )
    from paddle_tpu_torch.testing.load import (
        LoadSpec, generate_load, run_load,
    )

    tag = "parity" if quant == "none" else f"parity-{quant}"
    counters = {k: f for k, f in _serve_counters().items()
                if (k == "paged_decode") == (quant == "none")}
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2) if cfg is None else cfg
    params = init_llama_params(cfg, seed=0, device=device,
                               dtype=torch.float32)
    cpu_params = params_to(params, device="cpu")
    work = generate_load(LoadSpec(**dict(PARITY_LOAD,
                                           vocab=cfg.vocab_size)))
    logits = []
    for dev, p in ((device, params), (torch.device("cpu"), cpu_params)):
        ex = PagedExecutor(cfg, p, dtype=torch.float32, device=dev,
                           max_seqs=1, page_size=16, max_len=256,
                           quant=quant)
        with torch.no_grad():
            logits.append([ex._prefill_fwd(torch.as_tensor(
                w["prompt_ids"][None], dtype=torch.long, device=dev))[0]
                .cpu() for w in work])
    max_err = max((a - b).abs().max().item()
                  for a, b in zip(*logits))
    log(f"[{tag}] first-token logits card vs CPU: max_abs_err "
        f"{max_err:.3e} (atol 1e-3: fp32 on both, TF32 off, other "
        f"summation order through 2 layers of width 4096)")
    if not max_err <= 1e-3:
        raise AssertionError(f"[{tag}] logits differ by {max_err}")
    streams = {}
    cpu = torch.device("cpu")
    for dev, p, aot in ((device, params, "off"), (cpu, cpu_params, "off"),
                        (device, params, "warm")):
        before = {k: f.launches for k, f in counters.items()}
        eng = ServingEngine(cfg, p, dtype=torch.float32, device=dev,
                            quant=quant, aot=aot, **PARITY_KW)
        out = run_load(eng, work)
        streams[dev.type, aot] = {rid: h.tokens
                                  for rid, h in out["handles"].items()}
        launched = {k: f.launches - before[k] for k, f in counters.items()}
        dec = eng.executor.programs["decode"]
        log(f"[{tag}] {dev.type} aot={aot}: "
            f"{out['stats']['decode_steps']} decode steps, kernel launches "
            f"{launched}, serve.decode {dec.dispatches} calls, "
            f"{dec.traces} captured")
        if dev.type == "cuda" and not all(launched.values()):
            raise AssertionError(f"[{tag}] the card run missed a kernel: "
                                 f"{launched}")
    for aot in ("off", "warm"):
        if streams[device.type, aot] != streams["cpu", "off"]:
            raise AssertionError(f"[{tag}] {device.type} aot={aot}: greedy "
                                 f"streams differ from the CPU's: {streams}")
        log(f"[{tag}] {device.type} aot={aot}: greedy streams identical to "
            f"the CPU's (aot=off) for {len(work)} requests "
            f"({sum(map(len, streams['cpu', 'off'].values()))} tokens)")


#: 5b's load: phase 5's shape with a shared 32-token prefix and tiled
#: prompts, so the prefix cache hits and the n-gram proposer drafts
FEATURE_PARITY_LOAD = dict(PARITY_LOAD, n_requests=5, prompt_len=(16, 48),
                           max_new=(8, 12), prefix_share=0.6, prefix_len=32,
                           prefix_pool=1, repeat_share=0.5, repeat_period=4)
FEATURE_LEGS = {"off": {}, "prefix": dict(prefix_cache=True),
                "spec": dict(spec_decode="ngram"),
                "async": dict(async_exec=True)}


def phase_parity_features(device, cfg=None):
    """Phase 5b: phase 5's 2-layer cut in fp32, the prefix cache, spec
    decode and async each on alone: every leg's greedy streams must equal
    the off leg's and the CPU's (the plain kernels), token for token; the
    prefix leg must hit and the card's legs launch paged decode (the
    spec leg's drafts are reported: they follow the generated tokens).
    Then two verify windows drafted from the off streams themselves must
    accept 4 and 2 tokens and commit those streams' tokens, on the card
    as on the CPU."""
    from paddle_tpu_torch.inference.server import (
        PagedExecutor, ServingEngine,
    )
    from paddle_tpu_torch.models import (
        LlamaConfig, init_llama_params, params_to,
    )
    from paddle_tpu_torch.testing.load import LoadSpec, generate_load

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2) if cfg is None else cfg
    params = init_llama_params(cfg, seed=0, device=device,
                               dtype=torch.float32)
    cpu = torch.device("cpu")
    work = generate_load(LoadSpec(**dict(FEATURE_PARITY_LOAD,
                                         vocab=cfg.vocab_size)))
    counter = _serve_counters()["paged_decode"]
    streams = {}
    for dev, p in ((device, params), (cpu, params_to(params, device="cpu"))):
        for leg, kw in FEATURE_LEGS.items():
            before = counter.launches
            eng = ServingEngine(cfg, p, dtype=torch.float32, device=dev,
                                **dict(PARITY_KW, **kw))
            out = _run_audited(eng, work)
            st = out["stats"]
            streams[dev.type, leg] = {rid: h.tokens
                                      for rid, h in out["handles"].items()}
            launched = counter.launches - before
            log(f"[parity-5b] {dev.type} {leg}: {st['decode_steps']} decode "
                f"steps, {st['cached_tokens']} cached tokens, "
                f"{eng.metrics.draft_proposed} drafted / "
                f"{eng.metrics.draft_accepted} accepted, replans "
                f"{eng.scheduler.replans}, paged_decode launches {launched}")
            if leg == "prefix" and st["cached_tokens"] <= 0:
                raise AssertionError(f"[parity-5b] {dev.type}: no hit")
            if dev.type == "cuda" and not launched:
                raise AssertionError(f"[parity-5b] {leg}: no kernel launch")
            del eng
    for leg in FEATURE_LEGS:
        for dev in (device.type, "cpu"):
            if streams[dev, leg] != streams[dev, "off"]:
                raise AssertionError(
                    f"[parity-5b] {dev} {leg} differs from off at "
                    f"{_first_diff(streams[dev, leg], streams[dev, 'off'])}")
        if streams[device.type, leg] != streams["cpu", leg]:
            raise AssertionError(
                f"[parity-5b] {leg}: {device.type} differs from cpu at "
                f"{_first_diff(streams[device.type, leg], streams['cpu', leg])}")
    log(f"[parity-5b] prefix, spec and async each equal off, on "
        f"{device.type} and cpu, token for token ({len(work)} requests, "
        f"{sum(map(len, streams['cpu', 'off'].values()))} tokens)")
    # random weights seldom repeat a prompt token, so the spec leg may
    # draft nothing: verify two windows whose drafts are the off
    # stream's own continuation (the second wrong from its third token)
    want = streams["cpu", "off"]
    reqs = work[:2]
    cont = [want[w["rid"]] for w in reqs]
    drafts = [cont[0][1:5], cont[1][1:3] + [(cont[1][3] + 1)
                                            % cfg.vocab_size, 7]]
    got = {}
    for dev, p in ((device, params), (cpu, params_to(params, device="cpu"))):
        ex = PagedExecutor(cfg, p, dtype=torch.float32, device=dev,
                           max_seqs=2, page_size=PARITY_KW["page_size"],
                           max_len=PARITY_KW["max_len"])
        sids = [ex.alloc_slot() for _ in reqs]
        chunk = PARITY_KW["prefill_chunk"]
        for s, w in zip(sids, reqs):
            ids = w["prompt_ids"]
            for t in range(0, len(ids), chunk):
                ex.prefill_chunk(s, ids[t:t + chunk], t,
                                 final=t + chunk >= len(ids))
        got[dev.type] = ex.verify(sids, drafts, [5, 5], 4)
        del ex
    toks, acc = got["cpu"]
    if got[device.type] != got["cpu"] or list(acc.values()) != [4, 2] or \
            list(toks.values()) != [cont[0][1:6], cont[1][1:4]]:
        raise AssertionError(f"[parity-5b] verify with drafted "
                             f"continuations: {got}, want {cont}")
    log(f"[parity-5b] verify of two windows drafted from the off streams "
        f"(all 4 right; 2 right then wrong): accepted 4 and 2, the off "
        f"streams' next tokens, identical on {device.type} and cpu")


# -- phases 4g and 5c: durable serving --------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
#: the seed of every fault point's hit count drawn in 4g and 5c
DURABLE_SEED = 0


def _fleet_audit(cl):
    from paddle_tpu_torch.inference.server import check_pool_invariants
    from paddle_tpu_torch.inference.server.cluster import DEAD_STATES

    for rep in cl.replicas:
        if rep.state not in DEAD_STATES:
            check_pool_invariants(rep.engine.executor.cache,
                                  rep.engine.prefix)


def _drive_fleet(cl, work, until=None, handles=None, on_step=None):
    """Submit each request of ``work`` not in ``handles`` at its arrival
    tick and step the fleet until it drains (or its tick reaches
    ``until``), checking every live replica's pool after every step and
    calling ``on_step(cl, handles)``.  Returns (handles, seconds
    stepping, seconds auditing)."""
    handles = {} if handles is None else handles
    pending = [w for w in work if w["rid"] not in handles]
    serve = audit = 0.0
    while pending or cl.in_flight:
        if until is not None and cl.tick >= until:
            break
        if cl.tick > 2000:
            raise AssertionError("the fleet did not drain in 2000 ticks")
        t0 = time.perf_counter()
        while pending and pending[0]["arrival_tick"] <= cl.tick:
            w = pending.pop(0)
            handles[w["rid"]] = cl.submit(
                w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
                rid=w["rid"])
        cl.step()
        t1 = time.perf_counter()
        serve += t1 - t0
        _fleet_audit(cl)
        audit += time.perf_counter() - t1
        if on_step is not None:
            on_step(cl, handles)
    return handles, serve, audit


def _precapture(cl):
    """Capture every live replica's decode step at every batch size;
    returns the seconds."""
    from paddle_tpu_torch.inference.server.cluster import DEAD_STATES

    t0 = time.perf_counter()
    for rep in cl.replicas:
        if rep.state in DEAD_STATES:
            continue
        ex = rep.engine.executor
        for B in range(1, ex.cache.max_seqs + 1):
            ex.programs["decode"].aot_capture((B,))
    return time.perf_counter() - t0


def _check_complete(tag, handles, work):
    """Every request of ``work`` has one handle, FINISHED with exactly
    its max_new_tokens tokens."""
    from paddle_tpu_torch.inference.server import RequestState

    if sorted(handles) != sorted(w["rid"] for w in work):
        raise AssertionError(f"[{tag}] handles {sorted(handles)}")
    for w in work:
        h = handles[w["rid"]]
        if h.state is not RequestState.FINISHED \
                or len(h.tokens) != w["max_new_tokens"]:
            raise AssertionError(
                f"[{tag}] {w['rid']}: {h.state.value}, {len(h.tokens)} of "
                f"{w['max_new_tokens']} tokens")


def _run_child(cmd, kill_after=None, timeout=600):
    """Run a durability worker, SIGKILLing it once its journal holds
    ``kill_after`` records.  Returns (returncode, last progress line,
    seconds, output tail)."""
    t0 = time.perf_counter()
    env = dict(os.environ, PT_FAULTS="")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=ROOT)
    last, tail = None, collections.deque(maxlen=30)
    try:
        for line in proc.stdout:
            tail.append(line)
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"worker ran past {timeout} s")
            if line.startswith("tick "):
                last = line.strip()
                if kill_after is not None \
                        and int(line.split()[-1]) >= kill_after:
                    proc.send_signal(signal.SIGKILL)
                    break
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, last, time.perf_counter() - t0, "".join(tail)


def _worker(wal_dir, spec, config, device):
    return [sys.executable, "-m",
            "paddle_tpu_torch.testing.durability_worker", str(wal_dir),
            spec, "--device", device.type, "--config", config]


def _expect_exit(tag, got, want):
    rc, last, sec, tail = got
    if rc != want:
        raise AssertionError(f"[{tag}] the child exited {rc}, expected "
                             f"{want}; its output ends:\n{tail}")
    log(f"[{tag}] the child exited {rc} after {sec:.1f} s (last progress "
        f"line: {last})")


def _recover_and_serve(tag, cl, work, base, counters, t_rebuild,
                       what="the uninterrupted run's"):
    """Resubmit every request to a recovered fleet (at-least-once: a
    journaled rid dedups to its restored request), step until drained
    and hold the result: every request finished once; streams served
    from the journal and journaled prefixes equal to ``base`` (``what``
    names it).  Returns ({kernel: launches}, streams)."""
    rec = cl.recovery
    journaled = {rid: list(h.tokens)
                 for rid, h in cl.recovered_handles.items()}
    for f in counters.values():
        f.launches = 0
    first = []
    t0 = time.perf_counter()

    def on_step(c, handles):
        if not first and any(len(h.tokens) > len(journaled.get(rid, ()))
                             for rid, h in handles.items()):
            first.append((c.tick, time.perf_counter() - t0))

    handles = {w["rid"]: cl.submit(w["prompt_ids"],
                                   max_new_tokens=w["max_new_tokens"],
                                   rid=w["rid"]) for w in work}
    if cl.dedup_hits != len(journaled):
        raise AssertionError(f"[{tag}] {cl.dedup_hits} dedups for "
                             f"{len(journaled)} journaled requests")
    handles, serve_s, audit_s = _drive_fleet(cl, work, handles=handles,
                                             on_step=on_step)
    launches = {k: f.launches for k, f in counters.items()}
    _check_complete(tag, handles, work)
    streams = {rid: list(h.tokens) for rid, h in handles.items()}
    served = [rid for rid, h in cl.recovered_handles.items()
              if h._req.rid in cl._served]
    for rid in served:
        if streams[rid] != base[rid]:
            raise AssertionError(f"[{tag}] {rid} served from the journal "
                                 f"differs from {what} stream")
    for rid, toks in journaled.items():
        if toks != base[rid][:len(toks)]:
            raise AssertionError(f"[{tag}] {rid}: journaled prefix "
                                 f"{toks} is not {what}")
    resumed = {rid: streams[rid] for rid in streams if rid not in served}
    same, lead, total = _agreement(resumed, {r: base[r] for r in resumed})
    n_prefix = sum(len(journaled.get(r, ())) for r in resumed)
    log(f"[{tag}] recovery {rec}: {len(served)} streams served from the "
        f"journal equal {what}; {len(resumed)} resumed "
        f"(journaled prefixes {n_prefix} tokens, all equal); rebuild "
        f"{t_rebuild:.3f} s (the fleet and its graph captures); first "
        f"recovered token after {first[0][0] if first else None} ticks, "
        f"{first[0][1] if first else float('nan'):.3f} s; drained in "
        f"{cl.tick} ticks, {serve_s:.3f} s (+ {audit_s:.3f} s of pool "
        f"audits); launches {launches}; after the resume points {same} of "
        f"{len(resumed)} resumed streams equal {what}, "
        f"{lead} of {total} tokens before each first difference "
        f"(reported, not gated)")
    return launches, streams


def phase_durable(device, config="7b"):
    """Phase 4g (see the module docstring) on the durability worker's
    setup ``config`` (another than ``7b`` to rehearse on the CPU).
    Returns ({kernel: launches in the recovered fleets}, (config, params,
    engine kwargs, load, the uninterrupted streams)) for 4h."""
    from paddle_tpu_torch.inference.server import ServingCluster
    from paddle_tpu_torch.inference.server.wal import replay
    from paddle_tpu_torch.testing import durability_worker as worker
    from paddle_tpu_torch.testing import faults

    counters = _serve_counters()
    cfg, params, kw, work = worker.build(config, device)
    _sync(device)
    weights = (sum(t.numel() * t.element_size()
                   for t in params["layers"].values())
               + sum(params[k].numel() * params[k].element_size()
                     for k in ("embed", "norm", "lm_head"))) / 2**30
    rng = np.random.RandomState(DURABLE_SEED)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-4g-") as tmp:
        # (a) the journal off, then on, each fleet's decode graphs
        # captured before the load: equal streams, and the journal's
        # tax measured inside the journaled run (write_s, its fsyncs)
        streams = {}
        for mode in ("off", "on"):
            tag = f"4g-wal-{mode}"
            cl = ServingCluster(cfg, params, n_replicas=2, cluster=True,
                                wal=os.path.join(tmp, "uninterrupted")
                                if mode == "on" else False, **kw)
            if mode == "off":
                shared = all(
                    rep.engine.executor.layers[n].data_ptr()
                    == params["layers"][n].data_ptr()
                    for rep in cl.replicas for n in params["layers"])
                if not shared:
                    raise AssertionError(f"[{tag}] a replica copied the "
                                         f"weights")
                pool = [sum(t.numel() * t.element_size() for t in (
                    rep.engine.executor.cache._k_all,
                    rep.engine.executor.cache._v_all)) / 2**30
                    for rep in cl.replicas]
                log(f"[4g] 2 replicas share one copy of the weights "
                    f"({weights:.2f} GiB, the same tensors); each holds "
                    f"its KV pool ({', '.join(f'{g:.2f}' for g in pool)} "
                    f"GiB) and its graphs; "
                    + (f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                       f"allocated" if device.type == "cuda" else ""))
            cap = _precapture(cl)
            fsync = [0.0]
            if cl.wal is not None:
                inner = cl.wal._do_fsync

                def timed(inner=inner):
                    t0 = time.perf_counter()
                    try:
                        inner()
                    finally:
                        fsync[0] += time.perf_counter() - t0

                cl.wal._do_fsync = timed
            handles, serve_s, audit_s = _drive_fleet(cl, work)
            _check_complete(tag, handles, work)
            st = cl.stats()
            streams[mode] = {r: list(h.tokens) for r, h in handles.items()}
            wst = None if cl.wal is None else cl.wal.statusz()
            log(f"[{tag}] {len(work)} requests finished in {st['steps']} "
                f"ticks, {serve_s:.3f} s (+ {audit_s:.3f} s of pool "
                f"audits; {cap:.3f} s of captures before): "
                f"{st['decode_tokens']} decode tokens, "
                f"{st['decode_tokens'] / serve_s:.2f} decode tok/s, "
                f"{st['agg_tok_per_step']} tokens a tick; per replica "
                f"{[p['requests']['submitted'] for p in st['per_replica'].values()]} "
                f"requests"
                + ("" if wst is None else
                   f" | journal: {wst['appended']} records, "
                   f"{wst['fsyncs']} fsyncs (every {cl.wal.fsync_every}), "
                   f"write_s {wst['write_s']} (fsync {fsync[0]:.6f} s), "
                   f"{wst['write_s'] / serve_s:.4f} of the serving wall "
                   f"(the journal's tax, reported beside the reference's "
                   f"budget of a 0.95x throughput, wal.py), {wst['bytes']} "
                   f"bytes, {wst['errors']} errors"))
            del cl, handles
            _empty(device)
        base, ticks = streams["on"], st["steps"]
        if streams["off"] != base:
            raise AssertionError(
                f"[4g] journal on vs off: streams differ at "
                f"{_first_diff(streams['off'], base)}")
        log(f"[4g] journal on = off: identical greedy streams "
            f"({sum(map(len, base.values()))} tokens)")

        # (b) a whole-process crash: a child serves the load into a
        # journal and dies at the end of a seeded tick inside decode
        # (serve.step fires after each replica's step: 2 a tick)
        T = int(rng.randint(ticks // 2, 3 * ticks // 4 + 1))
        d = os.path.join(tmp, "crashed")
        _expect_exit("4g-crash", _run_child(_worker(
            d, f"serve.step:after:{2 * T}=crash", config, device)),
            faults.EXIT_CODE)
        t0 = time.perf_counter()
        recs, rep = replay(d, repair=False)
        replay_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cl = ServingCluster.recover(cfg, params, d, n_replicas=2,
                                    cluster=True, **kw)
        _precapture(cl)
        rebuild = time.perf_counter() - t0
        log(f"[4g-recover] the child crashed at the end of tick {T} of "
            f"{ticks}; its journal: {rep}, replayed in {replay_s:.4f} s")
        out = _recover_and_serve("4g-recover", cl, work, base, counters,
                                 rebuild)[0]
        if device.type == "cuda" and not out["paged_decode"]:
            raise AssertionError("[4g-recover] paged_decode never launched")
        del cl
        _empty(device)

        # (c) in process: a replica crash fails over by recompute; a hang
        # is salvaged (its running requests' pages copied)
        for action in ("crash", "hang"):
            tag = f"4g-{action}"
            K = 2 * int(rng.randint(ticks // 3, ticks // 2 + 1)) + 1
            faults.reset(f"replica.fail:before:{K}={action}")
            try:
                cl = ServingCluster(cfg, params, n_replicas=2, cluster=True,
                                    wal=False, beat_timeout=2, **kw)
                handles, serve_s, _ = _drive_fleet(cl, work)
            finally:
                faults.reset("")
            _check_complete(tag, handles, work)
            got = {r: list(h.tokens) for r, h in handles.items()}
            same, lead, total = _agreement(got, base)
            log(f"[{tag}] replica.fail:before:{K}={action}: "
                f"{cl.failovers} failovers, {cl.salvages} salvaged "
                f"requests ({cl.salvaged_pages} pages, "
                f"{cl.salvages_failed} fell back), {cl.restarts} restarts, "
                f"states {[r.state for r in cl.replicas]}; {len(work)} "
                f"requests finished in {cl.tick} ticks, {serve_s:.3f} s; "
                f"{same} of {len(base)} streams equal the uninterrupted "
                f"run's, {lead} of {total} tokens before each first "
                f"difference (reported, not gated)")
            if not cl.failovers or not cl.restarts:
                raise AssertionError(f"[{tag}] no failover or restart")
            if action == "hang" and not cl.salvages:
                raise AssertionError(f"[{tag}] nothing was salvaged")
            del cl, handles
            _empty(device)

        # (d) int8, in process and short: a journaled fleet stopped at a
        # seeded tick, dropped, and recovered from its journal
        d = os.path.join(tmp, "int8")
        T8 = int(rng.randint(ticks // 4, ticks // 3 + 1))
        cl = ServingCluster(cfg, params, n_replicas=2, cluster=True,
                            wal=d, quant="int8", **kw)
        handles, _, _ = _drive_fleet(cl, work, until=T8)
        pre = {w["rid"]: list(handles[w["rid"]].tokens)
               if w["rid"] in handles else [] for w in work}
        del cl, handles
        _empty(device)
        t0 = time.perf_counter()
        cl = ServingCluster.recover(cfg, params, d, n_replicas=2,
                                    cluster=True, quant="int8", **kw)
        _precapture(cl)
        rebuild = time.perf_counter() - t0
        log(f"[4g-int8] an int8 fleet journaled "
            f"{sum(map(len, pre.values()))} tokens of "
            f"{sum(1 for t in pre.values() if t)} requests by tick {T8}, "
            f"then was dropped")
        launches, _ = _recover_and_serve(
            "4g-int8", cl, work, pre, counters, rebuild,
            what="the dropped fleet's")
        if device.type == "cuda" and not (launches["paged_decode_quant"]
                                          and launches["quant_matmul"]):
            raise AssertionError(f"[4g-int8] launches {launches}")
        out["paged_decode_quant"] = launches["paged_decode_quant"]
        out["quant_matmul"] = launches["quant_matmul"]
        del cl
        _empty(device)
    return out, (cfg, params, kw, work, base)


def phase_parity_durable(device, config="parity"):
    """Phase 5c (see the module docstring) on the durability worker's
    setup ``config`` (``tiny`` to rehearse on the CPU)."""
    from paddle_tpu_torch.inference.server import ServingCluster
    from paddle_tpu_torch.inference.server.wal import replay, segment_paths
    from paddle_tpu_torch.models import params_to
    from paddle_tpu_torch.testing import durability_worker as worker
    from paddle_tpu_torch.testing import faults

    counters = _serve_counters()
    cfg, params, kw, work = worker.build(config, device)
    cpu = torch.device("cpu")
    rng = np.random.RandomState(DURABLE_SEED + 1)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-5c-") as tmp:
        journals, streams = {}, {}
        for dev, p in ((cpu, params_to(params, device="cpu")),
                       (device, params)):
            d = os.path.join(tmp, "uninterrupted", str(len(journals)))
            cl = ServingCluster(cfg, p, n_replicas=2, cluster=True, wal=d,
                                **dict(kw, device=dev))
            cl.wal.fsync_every = 1      # as the worker's
            handles, serve_s, _ = _drive_fleet(cl, work)
            _check_complete(f"5c-{dev.type}", handles, work)
            cl.wal.close()
            streams[dev.type] = {r: list(h.tokens)
                                 for r, h in handles.items()}
            journals[dev.type] = [open(q, "rb").read()
                                  for q in segment_paths(d)]
            log(f"[5c] {dev.type}: {len(work)} requests in {cl.tick} ticks, "
                f"{serve_s:.3f} s; journal {cl.wal.appended} records, "
                f"{sum(map(len, journals[dev.type]))} bytes")
            del cl, handles, p
        if journals[device.type] != journals["cpu"]:
            raise AssertionError("[5c] the card's journal differs from the "
                                 "CPU's")
        base = streams["cpu"]
        if streams[device.type] != base:
            raise AssertionError(f"[5c] card streams differ from the CPU's "
                                 f"at {_first_diff(streams[device.type], base)}")
        log(f"[5c] the card's journal of the uninterrupted run equals the "
            f"CPU's byte for byte ({sum(map(len, journals['cpu']))} bytes), "
            f"and so do its streams ({sum(map(len, base.values()))} tokens)")
        records, _ = replay(os.path.join(tmp, "uninterrupted", "0"),
                            repair=False)
        n = len(records)
        max_new = {w["rid"]: w["max_new_tokens"] for w in work}
        N = int(rng.randint(5 * n // 8, 7 * n // 8 + 1))  # late
        K = int(rng.randint(n // 4, n // 2 + 1))  # early: all in flight
        last = records[N - 1]
        split = (last["t"] == "token"
                 and last["i"] == max_new[last["rid"]] - 1)
        log(f"[5c] the crash depth {N} of {n} records is a {last['t']} "
            f"record" + (f": {last['rid']}'s last token, so its finish "
                         f"record is lost and recovery must finish it from "
                         f"the log" if split else ""))
        for tag, spec, kill, rc in (
                ("5c-crash", f"wal.append:after:{N}=crash", None,
                 faults.EXIT_CODE),
                ("5c-sigkill", "", K, -signal.SIGKILL)):
            d = os.path.join(tmp, tag)
            _expect_exit(tag, _run_child(_worker(d, spec, config, device),
                                         kill_after=kill), rc)
            t0 = time.perf_counter()
            cl = ServingCluster.recover(cfg, params, d, n_replicas=2,
                                        cluster=True, **kw)
            _precapture(cl)
            rebuild = time.perf_counter() - t0
            launches, got = _recover_and_serve(tag, cl, work, base, counters,
                                               rebuild, what="the CPU's")
            if got != base:
                raise AssertionError(f"[{tag}] recovered streams differ from "
                                     f"the CPU's at {_first_diff(got, base)}")
            if device.type == "cuda" and not launches["paged_decode"]:
                raise AssertionError(f"[{tag}] paged_decode never launched")
            log(f"[{tag}] ({'wal.append crash after record ' + str(N) if kill is None else f'SIGKILL at {K} records'} "
                f"of {n}): every recovered stream equals the CPU's "
                f"uninterrupted run token for token")
            del cl
            _empty(device)


def _elastic_fleet(setup, **kw):
    from paddle_tpu_torch.inference.server import ServingCluster

    cfg, params, ekw = setup[:3]
    return ServingCluster(cfg, params, n_replicas=2, cluster=True,
                          wal=False, **dict(ekw, **kw))


def _drain_join(cl, work, tag, late=2):
    """4h(a) / 5d: submit all of ``work`` but its last ``late`` requests
    at once, step three ticks, drain r0 (its queue re-steered), join a
    replica, submit the rest (the router sends them to the newcomer)
    and run to the end, the pools audited after every step.  Returns
    (handles, joined replica)."""
    handles = {w["rid"]: cl.submit(w["prompt_ids"],
                                   max_new_tokens=w["max_new_tokens"],
                                   rid=w["rid"]) for w in work[:-late]}
    t0 = time.perf_counter()
    for _ in range(3):
        cl.step()
        _fleet_audit(cl)
    queued = len(cl.replica("r0").engine.scheduler.queue)
    cl.drain("r0")
    new = cl.join()
    handles, serve_s, _ = _drive_fleet(cl, work, handles=handles)
    serve_s += time.perf_counter() - t0
    _check_complete(tag, handles, work)
    r0 = cl.replica("r0")
    if r0.state != "drained" or r0.engine.in_flight or not cl.resteered:
        raise AssertionError(f"[{tag}] r0 ends {r0.state} with "
                             f"{r0.engine.in_flight} in flight; "
                             f"{cl.resteered} re-steered")
    log(f"[{tag}] r0 drained after 3 ticks with {queued} queued: "
        f"{cl.resteered} re-steered, joined {new.name}; per replica "
        f"{[r.engine.metrics.submitted for r in cl.replicas]} admitted, "
        f"states {[r.state for r in cl.replicas]}; {len(work)} requests "
        f"in {cl.tick} ticks, {serve_s:.3f} s")
    return handles, new


def _disaggregated(cl, work, tag, counters):
    """4h(b, c) / 5d: serve ``work`` on a disaggregated fleet with the
    handoff audit on; gates the roles and each copy's crc32 where the
    pool holds the values it was given (not int8: write_at quantizes
    again).  Returns (handles, launches)."""
    cl.handoff_audit = []
    _zero_counts(counters)
    handles, serve_s, _ = _drive_fleet(cl, work)
    launches = _counts(counters)
    _check_complete(tag, handles, work)
    pre, dec = (r.engine.metrics for r in cl.replicas)
    if not cl.handoffs or dec.submitted or not dec.decode_tokens:
        raise AssertionError(
            f"[{tag}] handoffs {cl.handoffs}, decode replica admitted "
            f"{dec.submitted}, decoded {dec.decode_tokens} tokens")
    audit = cl.handoff_audit
    bad = [a["rid"] for a in audit if a["crc_src"] != a["crc_dst"]]
    if bad and cl.replicas[0].engine.executor.quant == "none":
        raise AssertionError(f"[{tag}] handed-off K/V differs by crc32: "
                             f"{bad}")
    per = ", ".join(
        f"{a['rid']} {a['tokens']} tok / {a['pages']} pages "
        f"{(a['gather_s'] + a['write_s']) * 1e3:.3f} ms "
        f"({a['bytes'] / (a['gather_s'] + a['write_s']) / 1e9:.1f} GB/s)"
        for a in audit)
    log(f"[{tag}] roles {[r.role for r in cl.replicas]}: {cl.handoffs} "
        f"handoffs ({cl.handoff_tokens} tokens, {cl.handoffs_skipped} "
        f"skipped), crc32 source = target for {len(audit) - len(bad)} of "
        f"{len(audit)}; the prefill replica admitted {pre.submitted} and "
        f"decoded {pre.decode_tokens} tokens, the decode replica "
        f"admitted {dec.submitted} and decoded {dec.decode_tokens}; "
        f"{len(work)} requests in {cl.tick} ticks, {serve_s:.3f} s; "
        f"launches {launches}; each handoff's gather_dense + write_at: "
        f"{per}")
    return handles, launches


def phase_elastic(device, setup):
    """Phase 4h (see the module docstring) on ``setup`` = 4g's (config,
    params, engine kwargs, load).  Returns {kernel: launches}: (b)'s
    paged_decode, (c)'s paged_decode_quant and quant_matmul."""
    counters = _serve_counters()
    work = setup[3]
    base = setup[4] if len(setup) > 4 else None

    def drift(tag, handles):
        if base is None:
            return
        got = {r: list(h.tokens) for r, h in handles.items()}
        same, lead, total = _agreement(got, base)
        log(f"[{tag}] against 4g's uninterrupted streams: {same} of "
            f"{len(base)} equal, {lead} of {total} tokens before each "
            f"first difference (reported, not gated)")

    # two slots a replica, so that r0 holds a queue when it is drained
    cl = _elastic_fleet(setup, max_seqs=2)
    handles, new = _drain_join(cl, work, "4h-drain-join")
    g = cl.graphs(new)
    log(f"[4h-drain-join] joined replica {new.name}: at the join "
        f"{cl.last_join['graphs_captured']} graphs, build "
        f"{cl.last_join['build_s']:.3f} s; after the load "
        f"{g['graphs_captured']} decode graphs captured in "
        f"{g['capture_s']:.3f} s (no compile cache: each replica captures "
        f"its own)")
    drift("4h-drain-join", handles)
    del cl, handles, new
    _empty(device)
    out = {}
    for quant in ("none", "int8"):
        tag = "4h-disagg" + ("-int8" if quant == "int8" else "")
        cl = _elastic_fleet(setup, disaggregated=True, quant=quant)
        handles, launches = _disaggregated(cl, work, tag, counters)
        if device.type == "cuda":
            need = (("paged_decode",) if quant == "none"
                    else ("paged_decode_quant", "quant_matmul"))
            if not all(launches[k] for k in need):
                raise AssertionError(f"[{tag}] launches {launches}")
            for k in need:
                out[k] = launches[k]
        if quant == "none":
            drift(tag, handles)
        del cl, handles
        _empty(device)
    return out


def phase_parity_elastic(device, config="parity"):
    """Phase 5d (see the module docstring) on the durability worker's
    setup ``config`` (``tiny`` to rehearse on the CPU)."""
    from paddle_tpu_torch.models import params_to
    from paddle_tpu_torch.testing import durability_worker as worker

    counters = _serve_counters()
    cfg, params, kw, work = worker.build(config, device)
    cpu = torch.device("cpu")
    got = {}
    for dev, p in ((cpu, params_to(params, device="cpu")),
                   (device, params)):
        setup = (cfg, p, dict(kw, device=dev), work)
        cl = _elastic_fleet(setup, max_seqs=1)
        h, _ = _drain_join(cl, work, f"5d-drain-join-{dev.type}", late=1)
        got[dev.type, "drain"] = {r: list(x.tokens) for r, x in h.items()}
        cl = _elastic_fleet(setup, disaggregated=True)
        h, _ = _disaggregated(cl, work, f"5d-disagg-{dev.type}", counters)
        got[dev.type, "disagg"] = {r: list(x.tokens) for r, x in h.items()}
        del cl, h, p, setup
    for leg in ("drain", "disagg"):
        want, have = got["cpu", leg], got[device.type, leg]
        if have != want:
            raise AssertionError(f"[5d-{leg}] card streams differ from the "
                                 f"CPU's at {_first_diff(have, want)}")
    log(f"[5d] drain + join and disaggregated: the card's streams equal "
        f"the CPU's token for token "
        f"({sum(map(len, got['cpu', 'drain'].values()))} tokens each)")
    _empty(device)


# -- phases 4i and 5e: the decoding and inference surface --------------------

#: 4i's generate: 8 prompts of 512 seeded tokens, 32 new tokens each
GEN_RUN = dict(batch=8, prompt=512, new=32)
#: 4i's PagedLlamaEngine over the same model
PAGED_ENGINE_KW = dict(max_seqs=8, page_size=16, max_len=1024)


def _weights_gb(model):
    return sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9


def _step_weight_bytes(weights, embed, tied, B):
    """Bytes of weights one decode step at batch B reads: every tensor in
    ``weights`` (the projections, scales, norms and an untied head) and B
    rows of the ``embed`` table, or the whole table when the head is tied
    to it."""
    rows = embed.shape[0] if tied else B
    return (sum(t.numel() * t.element_size() for t in weights)
            + rows * embed[0].numel() * embed.element_size())


def _gen_ids(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(1, cfg.vocab_size, (B, S))


def _kernels_moved(before):
    counters = _unet_train_counters()     # all eleven kernel wrappers
    return {k: f.launches - before[k] for k, f in counters.items()
            if f.launches != before[k]}


def _launch_state():
    return {k: f.launches for k, f in _unet_train_counters().items()}


def phase_decode_13b(device, cfg=None, run=None, engine_kw=None,
                     dtype=torch.bfloat16, load=None, serve_kw=None):
    """Phase 4i: Llama-2-13B at full width and all 40 layers on one card,
    random weights from seed 0: (a) ``LlamaForCausalLM(...).to(bf16)``
    and ``generate`` on ``run``'s seeded prompts (prefill ms, ms a decode
    step, tokens/s, peak memory; no kernel of the eleven launches); (b)
    ``PagedLlamaEngine`` over the same model: the same prompts and
    ``new - 1`` steps, exactly L paged_decode launches a step, its
    streams' agreement with (a) reported; (c) ``_predictor_legs``: the
    predictor's logits equal ``model(ids)`` bit for bit; (d) the model's
    ``serving_params`` in bf16 (then the model is dropped) served with
    ``quant="int8"`` through phase 4's load with graphs (phase_serve's
    gates: every request finishes with its length, exact launches), and
    8 decode steps at batch 8 timed.  Returns the launches of (b) and
    (d) by kernel."""
    from paddle_tpu_torch.inference import PagedLlamaEngine
    from paddle_tpu_torch.models import (
        LlamaConfig, LlamaForCausalLM, serving_params,
    )

    cfg = LlamaConfig.llama2_13b() if cfg is None else cfg
    run = GEN_RUN if run is None else run
    engine_kw = PAGED_ENGINE_KW if engine_kw is None else engine_kw
    tag = "decode-13b"
    L = cfg.num_hidden_layers
    _reset_peak(device)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    _sync(device)
    fp32_gb, fp32_s = _weights_gb(model), time.perf_counter() - t0
    model.to(dtype)
    _sync(device)
    log(f"[{tag}] {L} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads ({cfg.num_key_value_heads} kv), "
        f"D {cfg.head_dim}, intermediate {cfg.intermediate_size}: "
        f"{model.num_params():,} parameters, {fp32_gb:.2f} GB in fp32 "
        f"(built in {fp32_s:.1f} s), {_weights_gb(model):.2f} GB in "
        f"{dtype}; peak {_peak_gib(device):.2f} GiB")
    # (a) generate
    B, S, new = run["batch"], run["prompt"], run["new"]
    ids = torch.as_tensor(_gen_ids(cfg, B, S), device=device)
    before = _launch_state()
    _reset_peak(device)
    model.generate(ids, max_new_tokens=1)     # first calls, untimed
    _, t_pre = _timed(device, lambda: model.generate(ids, max_new_tokens=1))
    toks, t_all = _timed(device, lambda: model.generate(
        ids, max_new_tokens=new))
    peak = _peak_gib(device)
    step_ms = (t_all - t_pre) / (new - 1)
    embed = model.llama.embed_tokens.weight
    wb = _step_weight_bytes(
        [p for p in model.parameters() if p is not embed], embed,
        cfg.tie_word_embeddings, B)
    bound_ms = wb / HBM_BYTES_PER_S * 1e3
    moved = _kernels_moved(before)
    log(f"[{tag}] generate [{B}, {S}] + {new} tokens: prefill (and the "
        f"first token) {t_pre:.1f} ms, {step_ms:.2f} ms a decode step "
        f"(weight-read bound {bound_ms:.2f} ms: {wb / 1e9:.2f} GB, the "
        f"weights less all but {B} embedding rows, over "
        f"{HBM_BYTES_PER_S / 1e12:g} TB/s), {B * new / t_all * 1e3:.1f} "
        f"tokens/s over the whole call ({t_all:.1f} ms), peak "
        f"{peak:.2f} GiB (weights, the [{L}, {B}, {S + new}, "
        f"{cfg.num_key_value_heads}, {cfg.head_dim}] K and V caches, "
        f"activations); kernel launches {moved or 'none'}")
    if tuple(toks.shape) != (B, new) or toks.dtype != ids.dtype or not \
            bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"[{tag}] generate gave {toks.dtype} "
                             f"{tuple(toks.shape)}")
    if moved:
        raise AssertionError(f"[{tag}] generate launched kernels: {moved}")
    want = toks.cpu().tolist()
    # (b) PagedLlamaEngine over the same model
    counters = _serve_counters()
    t0 = time.perf_counter()
    eng = PagedLlamaEngine(model, dtype=dtype, **engine_kw)
    _sync(device)
    build_s = time.perf_counter() - t0
    resident = (torch.cuda.memory_allocated() / 2**30
                if device.type == "cuda" else float("nan"))
    log(f"[{tag}] PagedLlamaEngine {engine_kw} built in {build_s:.1f} s: "
        f"{resident:.2f} GiB resident (the "
        f"model, its stacked copy and the "
        f"{eng.cache._k_all.numel() * 2 * eng.cache._k_all.element_size() / 1e9:.2f}"
        f" GB page pool)")
    for f in counters.values():
        f.launches = 0
    sids = [eng.add_request(ids[b].cpu().numpy()) for b in range(B)]
    got = {s: [eng._last_token[s]] for s in sids}
    steps_ms = []
    for _ in range(new - 1):
        out, ms = _timed(device, eng.step)
        steps_ms.append(ms)
        for s in sids:
            got[s].append(out[s])
    launched = {k: f.launches for k, f in counters.items()}
    if device.type == "cuda" and launched != {
            "paged_decode": L * (new - 1), "paged_decode_quant": 0,
            "quant_matmul": 0}:
        raise AssertionError(f"[{tag}] PagedLlamaEngine launches "
                             f"{launched}, expected paged_decode {L} "
                             f"layers x {new - 1} steps")
    streams = [got[s] for s in sids]
    same, lead, total = _agreement(dict(enumerate(streams)),
                                   dict(enumerate(want)))
    log(f"[{tag}] PagedLlamaEngine: {B} prompts, {new - 1} steps: first "
        f"step (captures the decode graph) {steps_ms[0]:.1f} ms, then "
        f"{np.median(steps_ms[1:]):.2f} ms a step (median, host wall "
        f"synchronised); launches {launched} ({L} a step); streams vs "
        f"generate: {same} of {B} equal, {lead} of {total} tokens before "
        f"each stream's first difference (not gated: the prefill GEMMs' M "
        f"differs, bf16)")
    for s in sids:
        eng.finish(s)
    row1 = launched["paged_decode"]
    del eng
    _empty(device)
    # (c) the predictor, on the module as it lies and placed by a Config
    _predictor_legs(tag, model, ids[:1, :128])
    # (d) int8 serving on the model's weights; the model is dropped
    holder = {"model": model}
    del model

    def take():
        m = holder.pop("model")
        params = serving_params(m, device=device, dtype=dtype)
        del m
        gc.collect()
        return params

    got, engine, _ = phase_serve(
        device, cfg=cfg, load=load, dtype=dtype, quant="int8",
        tag="decode-13b int8 graph", params_fn=take, engine_kw=serve_kw)
    ex = engine.executor
    prompts = [ids[b].cpu().numpy() for b in range(B)]
    hs = _fill_slots(engine, prompts, 16)
    sids = sorted(h._req.sid for h in hs)
    ex.decode(sids)                       # the graph at batch B
    _, t = _timed(device, lambda: [ex.decode(sids) for _ in range(8)])
    _drain(engine, hs)
    w8 = _step_weight_bytes(
        [t for w in ex.layers.values()
         for t in (w.values() if isinstance(w, dict) else (w,))]
        + [ex.tops["norm_w"]]
        + ([] if ex._tied else [ex.tops["head_w"]]),
        ex.tops["embed"], ex._tied, B)
    log(f"[{tag}] int8 decode step at batch {B} (replayed graph, lengths "
        f"{S + 1}-{S + 8}): {t / 8:.2f} ms a step (host wall, synchronised) "
        f"| int8 weight-read bound {w8 / HBM_BYTES_PER_S * 1e3:.2f} ms "
        f"({w8 / 1e9:.2f} GB: int8 projections, scales, norms, bf16 head "
        f"and {B} embedding rows)")
    if device.type == "cuda" and not (got["paged_decode_quant"]
                                      and got["quant_matmul"]):
        raise AssertionError(f"[{tag}] int8 serving missed a kernel: {got}")
    del engine, ex, hs
    _empty(device)
    return {"paged_decode": row1, **{k: got[k] for k in (
        "paged_decode_quant", "quant_matmul")}}


def _predictor_legs(tag, model, ids, low_precision=None):
    """``Predictor(model)`` (the module's own parameters where they lie)
    and ``Predictor(model, config=Config())`` (placed on the card by the
    config, run through ``torch.func.functional_call``): logits equal
    ``model(ids)`` bit for bit.  With ``low_precision`` (a dtype name),
    also a predictor under ``Config.enable_low_precision``: its logits
    equal ``model(ids)`` after ``model.to(low_precision)`` bit for bit
    (the model is left cast), and lie within 2^-4 (16 bf16 ulps) of the
    largest |logit| of the uncast model's."""
    from paddle_tpu_torch.inference import Config, Predictor

    def logits(m):
        with torch.no_grad():
            return m(ids).float().cpu().numpy()

    def equal(what, got, want):
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"[{tag}] {what} logits differ: max "
                                 f"{np.abs(got - want).max()}")

    def config():         # the card by default; the CPU for a dry run
        cfg = Config()
        if ids.device.type == "cpu":
            cfg.disable_gpu()
        return cfg

    want = logits(model)
    equal("Predictor(model)", Predictor(model).run([ids])[0], want)
    equal("Predictor(model, config=Config())",
          Predictor(model, config=config()).run([ids])[0], want)
    done = (f"Predictor(model) and Predictor(model, config=Config()) on "
            f"ids {list(ids.shape)}: logits {list(want.shape)} equal "
            f"model(ids) bit for bit")
    if low_precision is not None:
        cfg = config()
        cfg.enable_low_precision(low_precision)
        got = Predictor(model, config=cfg).run([ids])[0]
        model.to(getattr(torch, low_precision))
        equal(f"enable_low_precision({low_precision!r})", got,
              logits(model))
        _float_close(f"{tag} {low_precision} predictor vs fp32",
                     torch.from_numpy(got), torch.from_numpy(want),
                     rel=2 ** -4)
        done += (f"; under enable_low_precision({low_precision!r}) equal "
                 f"model.to({low_precision})(ids) bit for bit")
    log(f"[{tag}] {done}")


#: 5e(ii): a head dim the kernels do not take (80), at 2 layers
D80_CONFIG = dict(vocab_size=32000, hidden_size=2560, intermediate_size=6912,
                  num_hidden_layers=2, num_attention_heads=32,
                  num_key_value_heads=32)


def _float_close(tag, got, want, rel=1e-5):
    scale = float(want.abs().max())
    err = float((got.float().cpu() - want.float().cpu()).abs().max())
    log(f"[{tag}] max_abs_err {err:.3e} against the largest |value| "
        f"{scale:.3e} (limit {rel:g} of it)")
    if not err <= rel * scale:
        raise AssertionError(f"[{tag}] differs: {err} > {rel} * {scale}")


def _decode_legs(model, prompts, new, device):
    """{leg: [B, new] token lists} of generate, PagedLlamaEngine and
    ServingEngine over ``model`` on ``device`` (fp32)."""
    from paddle_tpu_torch.inference import PagedLlamaEngine, ServingEngine
    from paddle_tpu_torch.models import serving_params

    ids = torch.as_tensor(prompts, device=device)
    out = {"generate": model.generate(ids, max_new_tokens=new).tolist()}
    eng = PagedLlamaEngine(model, max_seqs=len(prompts), page_size=16,
                           max_len=256)
    sids = [eng.add_request(p) for p in prompts]
    got = {s: [eng._last_token[s]] for s in sids}
    for _ in range(new - 1):
        for s, t in eng.step().items():
            got[s].append(t)
    out["PagedLlamaEngine"] = [got[s] for s in sids]
    del eng
    srv = ServingEngine(model.config, serving_params(model, device),
                        dtype=torch.float32, device=device,
                        **dict(PARITY_KW, max_seqs=len(prompts)))
    hs = [srv.submit(p, max_new_tokens=new) for p in prompts]
    while srv.in_flight:
        srv.step()
    out["ServingEngine"] = [list(h.tokens) for h in hs]
    del srv
    return out


def phase_parity_decoding(device, cfg=None, d80=None, new=8):
    """Phase 5e, card against CPU in fp32: (i) Llama-2-13B's width at 2
    layers: generate, PagedLlamaEngine and ServingEngine on the same two
    prompts give the same tokens on each device, and the card's equal
    the CPU's, then ``_predictor_legs`` with a bf16 low-precision leg;
    (ii) head dim 80 served by ServingEngine: the dense route
    (no paged_decode launch), the CPU's streams, and PT_PAGED_IMPL=pallas
    raises; (iii) nn.Transformer at its defaults: the forward under
    generate_square_subsequent_mask within 1e-5 of the largest value of
    the CPU's, and 8 one-token steps through the decoder with gen_cache
    equal to the full causal forward."""
    from paddle_tpu_torch.inference import ServingEngine, paged
    from paddle_tpu_torch.models import (
        LlamaConfig, LlamaForCausalLM, init_llama_params, params_to,
    )
    from paddle_tpu_torch.testing.load import (
        LoadSpec, generate_load, run_load,
    )

    cpu = torch.device("cpu")
    tag = "parity-5e"
    # (i) 13B width, 2 layers
    cfg = LlamaConfig.llama2_13b(num_hidden_layers=2) if cfg is None else cfg
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    prompts = _gen_ids(cfg, 2, 24, seed=3)
    counters = _serve_counters()
    before = counters["paged_decode"].launches
    legs = {}
    for dev in (device, cpu):
        model.to(dev)
        legs[dev.type] = _decode_legs(model, prompts, new, dev)
        if dev.type == "cuda" and \
                counters["paged_decode"].launches == before:
            raise AssertionError(f"[{tag}] the card's engines launched no "
                                 "paged_decode")
    for dev, got in legs.items():
        first = got["generate"]
        for leg, toks in got.items():
            if toks != first:
                raise AssertionError(f"[{tag}] {dev} {leg} differs from "
                                     f"generate: {toks} vs {first}")
    if legs[device.type] != legs["cpu"]:
        raise AssertionError(f"[{tag}] card vs CPU: {legs}")
    log(f"[{tag}] 13B width x {cfg.num_hidden_layers} layers, fp32: "
        f"generate = PagedLlamaEngine = ServingEngine on the card and on "
        f"the CPU, and card = CPU ({2 * new} tokens a leg)")
    model.to(device)
    _predictor_legs(tag, model, torch.as_tensor(
        _gen_ids(cfg, 1, 128, seed=4), device=device),
        low_precision="bfloat16")
    del model
    _empty(device)
    # (ii) head dim 80
    cfg80 = LlamaConfig(**(D80_CONFIG if d80 is None else d80))
    params = init_llama_params(cfg80, seed=0, device=device,
                               dtype=torch.float32)
    work = generate_load(LoadSpec(**dict(PARITY_LOAD,
                                           vocab=cfg80.vocab_size)))
    streams = {}
    for dev, p in ((device, params), (cpu, params_to(params, device=cpu))):
        pd0 = counters["paged_decode"].launches
        dn0 = paged.dense_paged_attention.launches
        eng = ServingEngine(cfg80, p, dtype=torch.float32, device=dev,
                            **PARITY_KW)
        out = run_load(eng, work)
        streams[dev.type] = {r: h.tokens for r, h in out["handles"].items()}
        pd, dn = (counters["paged_decode"].launches - pd0,
                  paged.dense_paged_attention.launches - dn0)
        log(f"[{tag}] head dim {cfg80.head_dim} on {dev.type}: "
            f"{out['stats']['decode_steps']} decode steps, paged_decode "
            f"launches {pd}, dense route calls {dn} (graph replays "
            f"included)")
        if pd or not dn:
            raise AssertionError(f"[{tag}] head dim 80 took the kernel "
                                 f"({pd}) or not the dense route ({dn})")
        del eng
    if streams[device.type] != streams["cpu"]:
        raise AssertionError(f"[{tag}] head dim 80: card vs CPU "
                             f"{_first_diff(streams[device.type], streams['cpu'])}")
    old = os.environ.get("PT_PAGED_IMPL")
    os.environ["PT_PAGED_IMPL"] = "pallas"
    try:
        eng = ServingEngine(cfg80, params, dtype=torch.float32,
                            device=device, **PARITY_KW)
        eng.submit(work[0]["prompt_ids"], max_new_tokens=4)
        for _ in range(64):
            eng.step()
    except ValueError as e:
        log(f"[{tag}] head dim 80 with PT_PAGED_IMPL=pallas raises: "
            f"{str(e)[:100]}...")
    else:
        raise AssertionError(f"[{tag}] PT_PAGED_IMPL=pallas served head "
                             "dim 80")
    finally:
        if old is None:
            del os.environ["PT_PAGED_IMPL"]
        else:
            os.environ["PT_PAGED_IMPL"] = old
    log(f"[{tag}] head dim 80: card = CPU for {len(work)} requests "
        f"({sum(map(len, streams['cpu'].values()))} tokens)")
    del eng, params
    _empty(device)
    # (iii) nn.Transformer at its defaults
    _transformer_parity(device, tag)


def _transformer_parity(device, tag, S_src=128, S_tgt=8, seed=0):
    """5e(iii): ``nn.Transformer()`` (eval, dropout 0, seeded weights) on
    the card and the CPU: the full forward under the causal mask, and
    ``S_tgt`` one-token steps through the decoder's layers with
    ``gen_cache`` against it.  The encoder's maskless self-attention at
    S = 128 takes the short-attention kernel on the card."""
    import copy

    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.ops.kernels import short_attention as sa

    model = pnn.Transformer(dropout=0.0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if p.dim() > 1:
                p.normal_(0.0, 0.02, generator=gen)
            elif "norm" not in n:
                p.normal_(0.0, 0.02, generator=gen)
    model.eval()
    rng = np.random.RandomState(seed)
    src = torch.from_numpy(rng.randn(2, S_src, 512).astype(np.float32))
    tgt = torch.from_numpy(rng.randn(2, S_tgt, 512).astype(np.float32))
    outs = {}
    for dev, m in ((device, model), (torch.device("cpu"),
                                     copy.deepcopy(model).cpu())):
        mask = pnn.Transformer.generate_square_subsequent_mask(S_tgt, dev)
        s, t = src.to(dev), tgt.to(dev)
        k0 = sa.short_attention_fwd.launches
        with torch.no_grad():
            full = m(s, t, tgt_mask=mask)
            memory = m.encoder(s)
            cache = m.decoder.gen_cache(memory)
            steps = []
            for i in range(S_tgt):
                o, cache = m.decoder(t[:, i:i + 1], memory, cache=cache)
                steps.append(o)
        inc = torch.cat(steps, dim=1)
        _float_close(f"{tag} transformer {dev.type}: incremental vs full",
                     inc, full)
        outs[dev.type] = full
        if dev.type == "cuda":
            log(f"[{tag}] transformer on the card: short-attention "
                f"launches {sa.short_attention_fwd.launches - k0} (the "
                f"encoder's 6 self-attentions at S = {S_src}, twice)")
    _float_close(f"{tag} transformer card vs CPU", outs[device.type],
                 outs["cpu"])


# -- phase 6 -----------------------------------------------------------------

TRAIN_RUN = dict(batch=4, seq=2048, steps=5, lr=1e-4)


def _train_counters():
    from paddle_tpu_torch.ops.kernels import long_attention as la
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    from paddle_tpu_torch.ops.kernels import short_attention as sa

    return {"rms_norm_fwd": rn.rms_norm_fwd, "rms_norm_bwd": rn.rms_norm_bwd,
            "attention_fwd": la.attention_fwd,
            "attention_bwd": la.attention_bwd,
            "short_attention_fwd": sa.short_attention_fwd,
            "short_attention_bwd": sa.short_attention_bwd}


def phase_train(device, limit, cfg=None, run=None, tag="train"):
    """Llama-2-7B width x 8 layers: one warm-up step and ``steps`` timed
    ones.  Returns ({kernel: launches over all steps}, step, batch).
    Attention takes the long_attention kernels at S >= 1024 (the long
    route up to 2048, the flash route above) and the short one below,
    2L forward and L backward launches per step either way."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models import (
        CompiledTrainStep, LlamaConfig, LlamaForCausalLM,
    )

    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=8, recompute=True,
                                       recompute_policy="full",
                                       attention_impl="auto")
    run = dict(TRAIN_RUN, **(run or {}))
    B, S, n = run["batch"], run["seq"], run["steps"]
    L = cfg.num_hidden_layers
    on_card = device.type == "cuda"
    set_flags({"FLAGS_use_fused_rms_norm": True})
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    step = CompiledTrainStep(model, lr=run["lr"], compute_dtype="bfloat16",
                             moments_dtype="bfloat16", device=device)
    nparams = model.num_params()
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S))
    batch = (torch.as_tensor(ids, device=device),) * 2  # inputs = labels
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log(f"[{tag}] {L} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads, D {cfg.head_dim}, intermediate "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}: "
        f"{nparams / 1e9:.3f} B parameters, bf16 compute, fp32 master, "
        f"bf16 moments, built in {time.perf_counter() - t0:.1f} s")
    counters = _train_counters()
    long = S >= 1024
    per_step = {"rms_norm_fwd": 4 * L + 1, "rms_norm_bwd": 2 * L + 1,
                "attention_fwd": 2 * L if long else 0,
                "attention_bwd": L if long else 0,
                "short_attention_fwd": 0 if long else 2 * L,
                "short_attention_bwd": 0 if long else L}
    for f in counters.values():
        f.launches = 0
    losses, step_ms = [], []
    for i in range(n + 1):
        before = {k: f.launches for k, f in counters.items()}
        t1 = time.perf_counter()
        loss = float(step.step(*batch))       # float() synchronises
        ms = (time.perf_counter() - t1) * 1e3
        losses.append(loss)
        if i:
            step_ms.append(ms)
        got = {k: f.launches - before[k] for k, f in counters.items()}
        log(f"[{tag}] step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{loss:.6f}, {ms:.1f} ms, launches {got}")
        if on_card and got != per_step:
            raise AssertionError(f"[{tag}] step {i} launched {got}, expected "
                                 f"{per_step} (full recompute: every layer "
                                 f"forward runs twice)")
    launches = {k: f.launches for k, f in counters.items()}
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] losses {losses}: not finite and "
                             "falling")
    mean_ms = float(np.mean(step_ms))
    tokens = B * S
    mfu = model.flops_per_token(S) * tokens / (mean_ms / 1e3) / BF16_FLOPS
    peak = (torch.cuda.max_memory_allocated() / 2**30 if on_card
            else float("nan"))
    log(f"[{tag}] B={B} S={S}: step {mean_ms:.1f} ms (mean of {n}; "
        f"{', '.join(f'{m:.1f}' for m in step_ms)}) | "
        f"{tokens / (mean_ms / 1e3):.1f} tokens/s | MFU {mfu:.4f} "
        f"(6N + 12LhS = {model.flops_per_token(S):.4e} flops/token over "
        f"{BF16_FLOPS / 1e12:g} TFLOP/s bf16) | peak memory {peak:.2f} GiB | "
        f"losses {losses} | {limit}")
    return launches, step, batch


def phase_train_profile(step, batch, device):
    """One traced training step: device time by kind and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    counters = _train_counters()
    saved = {k: f.launches for k, f in counters.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    for k, f in counters.items():        # the traced step does not count
        f.launches = saved[k]
    kinds = {"rms_norm_fwd": 0.0, "rms_norm_bwd": 0.0, "attention_fwd": 0.0,
             "attention_bwd": 0.0, "gemm": 0.0, "other": 0.0}
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        name = ev.key.lower()
        kind = ("rms_norm_fwd" if "rms_norm_fwd" in name else
                "rms_norm_bwd" if "rms_norm_bwd" in name else
                "attention_fwd" if ("attn_fwd" in name
                                    or "attn_wg_fwd" in name) else
                "attention_bwd" if ("attn_bwd" in name or "attn_wg_dkdv"
                                    in name or "attn_wg_dq" in name
                                    or "attn_delta" in name) else
                "gemm" if any(k in name for k in ("gemm", "cutlass", "xmma",
                                                  "nvjet", "sm90_"))
                else "other")
        kinds[kind] += ms
        per_kernel[ev.key[:60]] = (ms, ev.count)
    busy = sum(kinds.values())
    log(f"[profile-train] one step traced: {wall:.1f} ms wall | device busy "
        f"{busy:.1f} ms ({', '.join(f'{k} {v:.1f}' for k, v in kinds.items())}"
        f") | idle share {1 - busy / wall:.3f}")
    for name, (ms, calls) in sorted(per_kernel.items(),
                                    key=lambda kv: -kv[1][0])[:10]:
        log(f"[profile-train]   {ms:9.2f} ms  {calls:5d} launches  {name}")


# -- phase 7 -----------------------------------------------------------------

def phase_train_parity(device, steps=3):
    """The same weights trained on the card (kernels) and on the CPU
    (plain versions), fp32, at a width that takes the attention kernel."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models import (
        CompiledTrainStep, LlamaConfig, LlamaForCausalLM,
    )

    set_flags({"FLAGS_use_fused_rms_norm": True})
    cfg = LlamaConfig(vocab_size=4096, hidden_size=256,
                      intermediate_size=688, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=2,
                      max_position_embeddings=1024, recompute=True)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 1024))
    counters = _train_counters()
    losses = {}
    for dev in (device, torch.device("cpu")):
        model = LlamaForCausalLM(cfg, device="cpu", seed=3)
        step = CompiledTrainStep(model, lr=1e-3, device=dev)
        before = {k: f.launches for k, f in counters.items()}
        batch = (torch.as_tensor(ids, device=dev),) * 2
        losses[dev.type] = [float(step.step(*batch)) for _ in range(steps)]
        launched = {k: f.launches - before[k] for k, f in counters.items()}
        log(f"[train-parity] {dev.type}: losses {losses[dev.type]}, kernel "
            f"launches {launched}")
        used = ("rms_norm_fwd", "rms_norm_bwd", "attention_fwd",
                "attention_bwd")
        if dev.type == "cuda" and not all(launched[k] for k in used):
            raise AssertionError("[train-parity] the card run missed a "
                                 f"kernel: {launched}")
    got, want = np.array(losses[device.type]), np.array(losses["cpu"])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    log(f"[train-parity] {steps} fp32 steps, 2 layers, hidden 256, S=1024: "
        f"max relative loss difference card vs CPU {rel:.3e} (limit 1e-4: "
        f"fp32 on both, TF32 off, other summation orders)")
    if not rel <= 1e-4:
        raise AssertionError(f"[train-parity] losses differ: {losses}")


# -- phases 6e-6h: the train step's graph, SR, remat policies, the gate --------

#: phase 6e: Llama-2-7B at all 32 layers, one card (bfloat16_sr)
FULL_RUN = dict(batch=4, seq=2048, k=3, eager=2, lr=1e-4)


def _per_step(L, long=True):
    """Launches per Llama step under full recompute: 4L+1 / 2L+1 RMSNorm
    forward / backward, 2L / L attention forward / backward."""
    return {"rms_norm_fwd": 4 * L + 1, "rms_norm_bwd": 2 * L + 1,
            "attention_fwd": 2 * L if long else 0,
            "attention_bwd": L if long else 0,
            "short_attention_fwd": 0 if long else 2 * L,
            "short_attention_bwd": 0 if long else L}


def _zero_counts(counters):
    for f in counters.values():
        f.launches = 0


def _counts(counters):
    return {k: f.launches for k, f in counters.items()}


def _timed(device, fn):
    """(result, ms) of ``fn()`` on the host clock, synchronised."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _traced(fn):
    """(wall ms, device busy ms) of one traced ``fn()``: busy is the union
    of the device kernels' intervals, replayed graph kernels included
    (NaN without a card).  Not their sum: kernels that cuBLAS and cuDNN
    launch as programmatic dependents start before the one ahead ends,
    and at the UNet's 64 x 64 step the sum exceeded the step's wall by
    29%.  Only the device activity is recorded: the host's
    operator events cost seconds to collect at an eager UNet step and
    nothing here reads them."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return _timed(torch.device("cpu"), fn)[1], float("nan")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall, busy / 1e3


def _llama_step(cfg, device, master="float32", lr=1e-4, seed=0, **kw):
    from paddle_tpu_torch.models import CompiledTrainStep, LlamaForCausalLM

    model = LlamaForCausalLM(cfg, device=device, seed=seed)
    return CompiledTrainStep(model, lr=lr, compute_dtype="bfloat16",
                             moments_dtype="bfloat16", master_dtype=master,
                             device=device, **kw)


def _ids(vocab, B, S, device, seed=0):
    ids = np.random.RandomState(seed).randint(0, vocab, (B, S))
    return (torch.as_tensor(ids, device=device),) * 2  # inputs = labels


def phase_train_full(device, limit, cfg=None, run=None):
    """6e: Llama-2-7B at all 32 layers on one card: bf16 parameters that
    are their own master (master_dtype="bfloat16_sr"), bf16 moments,
    full recompute.  One eager warm-up step and ``eager`` timed eager
    steps, then ``k`` steps through multi_step(k) twice: the first call
    warms up (its update gated off), captures and replays, the second
    only replays.  Returns the kernels' launches in the eager steps,
    counted where each wrapper launches, and the tally the replayed call
    added."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models import LlamaConfig

    cfg = cfg or LlamaConfig.llama2_7b(recompute=True,
                                       recompute_policy="full",
                                       attention_impl="auto")
    run = dict(FULL_RUN, **(run or {}))
    B, S, k = run["batch"], run["seq"], run["k"]
    L = cfg.num_hidden_layers
    on_card = device.type == "cuda"
    set_flags({"FLAGS_use_fused_rms_norm": True})
    t0 = time.perf_counter()
    step = _llama_step(cfg, device, master="bfloat16_sr", lr=run["lr"])
    model = step.model
    nparams = model.num_params()
    state_gib = sum(t.numel() * t.element_size()
                    for tree in (step.params, step._m, step._v)
                    for t in tree.values()) / 2**30
    batch = _ids(cfg.vocab_size, B, S, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log(f"[train-full] {L} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads, intermediate "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}: "
        f"{nparams / 1e9:.3f} B parameters, bf16 compute, "
        f"master_dtype=bfloat16_sr (no fp32 master), bf16 moments, full "
        f"recompute; parameters + moments {state_gib:.2f} GiB; built in "
        f"{time.perf_counter() - t0:.1f} s")
    counters = _train_counters()
    per_step = _per_step(L, long=S >= 1024)
    losses, eager_ms = [], []
    eager_launches = {n: 0 for n in per_step}
    for i in range(run["eager"] + 1):
        _zero_counts(counters)
        loss, ms = _timed(device, lambda: float(step.step(*batch)))
        got = _counts(counters)
        for n, c in got.items():
            eager_launches[n] += c
        losses.append(loss)
        if i:
            eager_ms.append(ms)
        log(f"[train-full] eager step {i}{' (warm-up)' if i == 0 else ''}: "
            f"loss {loss:.6f}, {ms:.1f} ms, launches {got}")
        if on_card and got != per_step:
            raise AssertionError(f"[train-full] eager step launched {got}, "
                                 f"expected {per_step}")
    if on_card:
        torch.cuda.empty_cache()
    _zero_counts(counters)
    _, first_ms = _timed(device, lambda: step.multi_step(k, *batch))
    first = step.last_losses.tolist()
    _zero_counts(counters)
    _, graph_ms = _timed(device, lambda: step.multi_step(k, *batch))
    launches = _counts(counters)
    second = step.last_losses.tolist()
    losses += first + second
    want = {n: k * c for n, c in per_step.items()}
    log(f"[train-full] multi_step({k}) first call (warm-up with the update "
        f"gated off, capture, replay): {first_ms:.1f} ms, "
        f"losses {first}; second call (replay): {graph_ms:.1f} ms, losses "
        f"{second}; launches under replay {launches} (expected {want}); "
        f"graphs captured {step._graph.traces} in "
        f"{step._graph.seconds:.1f} s")
    if on_card and launches != want:
        raise AssertionError(f"[train-full] replay launched {launches}, "
                             f"expected {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[train-full] losses {losses}: not finite and "
                             "falling")
    eager = float(np.mean(eager_ms))
    graph = graph_ms / k
    tokens = B * S
    fpt = model.flops_per_token(S)
    peak = (torch.cuda.max_memory_allocated() / 2**30 if on_card
            else float("nan"))
    for how, ms in (("eager step()", eager), (f"multi_step({k})", graph)):
        log(f"[train-full] B={B} S={S} {how}: {ms:.1f} ms a step | "
            f"{tokens / (ms / 1e3):.1f} tokens/s | MFU "
            f"{fpt * tokens / (ms / 1e3) / BF16_FLOPS:.4f} (6N + 12LhS = "
            f"{fpt:.4e} flops/token over {BF16_FLOPS / 1e12:g} TFLOP/s "
            f"bf16)")
    log(f"[train-full] peak memory {peak:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30 if on_card else float('nan'):.2f} | "
        f"losses {losses} | {limit}")
    log(f"[train-full] kernel launches in the {run['eager'] + 1} eager "
        f"steps, counted at launch: {eager_launches}; tallied by the "
        f"replay of multi_step({k}): {launches}")
    return eager_launches, launches


def _state_equal(a, b):
    """Names of the state tensors (parameters, master, m, v) that differ
    bit for bit between two train steps."""
    bad = []
    for name in ("params", "_master", "_m", "_v"):
        ta, tb = getattr(a, name), getattr(b, name)
        bad += [f"{name}[{k}]" for k in ta if not torch.equal(ta[k], tb[k])]
    return bad


def phase_graph_ab(device, limit, cfg=None, run=None, master="float32"):
    """6f: ``k`` eager steps from one state and multi_step(k) from an
    equal one (two models built from one seed), twice over; losses and
    every parameter, master and moment tensor compared bit for bit, the
    ms per step both ways, and one traced eager step and one traced
    replay with their idle shares."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models import LlamaConfig

    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=4, recompute=True,
                                       recompute_policy="full",
                                       attention_impl="auto")
    run = dict(TRAIN_RUN, **(run or {}))
    B, S, k = run["batch"], run["seq"], 4
    tag = f"graph-ab {master}"
    set_flags({"FLAGS_use_fused_rms_norm": True})
    eager = _llama_step(cfg, device, master=master, lr=run["lr"])
    graph = _llama_step(cfg, device, master=master, lr=run["lr"])
    batch = _ids(cfg.vocab_size, B, S, device)
    same = {}
    times = {"eager": [], "graph": []}
    for rnd in range(2):
        el, ms = _timed(device, lambda: [float(eager.step(*batch))
                                         for _ in range(k)])
        times["eager"].append(ms / k)
        _, ms = _timed(device, lambda: graph.multi_step(k, *batch))
        times["graph"].append(ms / k)
        gl = graph.last_losses.tolist()
        bad = _state_equal(eager, graph)
        same[rnd] = (el == gl, bad)
        log(f"[{tag}] round {rnd}: eager losses {el} | graph losses {gl} | "
            f"equal {el == gl}; state tensors that differ: {len(bad)} of "
            f"{sum(len(getattr(eager, n)) for n in ('params', '_master', '_m', '_v'))}"
            f"{' ' + str(bad[:4]) if bad else ''}")
    ew, eb = _traced(lambda: [eager.step(*batch) for _ in range(k)])
    gw, gb = _traced(lambda: graph.multi_step(k, *batch))
    log(f"[{tag}] B={B} S={S}, {cfg.num_hidden_layers} layers: eager "
        f"{times['eager'][1]:.1f} ms a step, multi_step({k}) "
        f"{times['graph'][1]:.1f} ms a step (round 0 with capture: "
        f"{times['graph'][0]:.1f}) | traced {k} steps: eager wall "
        f"{ew:.1f} ms, busy {eb:.1f} ms, idle share {1 - eb / ew:.3f}; "
        f"graph wall {gw:.1f} ms, busy {gb:.1f} ms, idle share "
        f"{1 - gb / gw:.3f} | {limit}")
    exact = all(eq and not bad for eq, bad in same.values())
    if master == "float32" and not exact:
        raise AssertionError(f"[{tag}] the graph's steps are not the eager "
                             f"steps bit for bit: {same}")
    if not exact:
        # SR mode: hold the replays at the bf16 tolerance
        worst = max(float(((graph.params[n].float() - eager.params[n].float())
                           .norm() / eager.params[n].float().norm()))
                    for n in eager.params)
        log(f"[{tag}] replays differ from eager: worst parameter relative "
            f"difference {worst:.3e} (limit 2e-2, bf16)")
        if not worst <= 2e-2:
            raise AssertionError(f"[{tag}] replays drifted: {worst}")
    else:
        log(f"[{tag}] the registered generators make replays equal eager "
            f"bit for bit" if master == "bfloat16_sr" else
            f"[{tag}] replays equal eager bit for bit")
    del eager, graph
    gc.collect()
    torch.cuda.empty_cache()


POLICIES = ("full", "save_mlp", "save_attn", "dots")


def phase_remat_policies(device, limit, cfg=None, run=None, grad_cfg=None,
                         grad_run=None):
    """6g: each recompute policy at 4 layers of 7B (bf16 compute, fp32
    master): one warm-up and two timed eager steps, step ms and peak
    memory; then loss and gradients in fp32 at the same shape, each
    policy against "full" (relative 1e-6)."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    set_flags({"FLAGS_use_fused_rms_norm": True})
    run = dict(TRAIN_RUN, **(run or {}))
    B, S = run["batch"], run["seq"]
    on_card = device.type == "cuda"
    for pol in POLICIES:
        c = cfg or LlamaConfig.llama2_7b(num_hidden_layers=4, recompute=True)
        c = LlamaConfig(**{**c.__dict__, "recompute_policy": pol})
        step = _llama_step(c, device, lr=run["lr"])
        batch = _ids(c.vocab_size, B, S, device)
        float(step.step(*batch))
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _, ms = _timed(device, lambda: [float(step.step(*batch))
                                        for _ in range(2)])
        peak = (torch.cuda.max_memory_allocated() / 2**30 if on_card
                else float("nan"))
        log(f"[remat] {pol}: {ms / 2:.1f} ms a step, peak memory "
            f"{peak:.2f} GiB ({c.num_hidden_layers} layers, B={B} S={S}, "
            f"bf16, fp32 master) | {limit}")
        del step, batch
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    gcfg = grad_cfg or LlamaConfig.llama2_7b(num_hidden_layers=4,
                                             recompute=True)
    grun = dict(dict(batch=B, seq=S), **(grad_run or {}))
    ref = None
    for pol in POLICIES:
        c = LlamaConfig(**{**gcfg.__dict__, "recompute_policy": pol})
        model = LlamaForCausalLM(c, device=device, seed=5)
        ids, labels = _ids(c.vocab_size, grun["batch"], grun["seq"], device,
                           seed=2)
        loss = model(ids, labels)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
        got = (float(loss.detach()), dict(zip(names, grads)))
        del model
        if ref is None:
            ref = got
            continue
        worst = max(float((got[1][n] - ref[1][n]).norm()
                          / ref[1][n].norm().clamp(min=1e-30))
                    for n in names)
        exact = all(torch.equal(got[1][n], ref[1][n]) for n in names)
        rel = abs(got[0] - ref[0]) / abs(ref[0])
        log(f"[remat] {pol} vs full, fp32, {c.num_hidden_layers} layers: "
            f"loss {got[0]!r} vs {ref[0]!r} (relative {rel:.3e}), worst "
            f"gradient relative difference {worst:.3e}, bit for bit "
            f"{exact} (limit 1e-6)")
        if not (rel <= 1e-6 and worst <= 1e-6):
            raise AssertionError(f"[remat] {pol} changes the gradients")


class Poisoned(torch.nn.Module):
    """A Llama whose loss adds the buffer ``poison`` (0; NaN or 1e6 for a
    poisoned step): the guard's fault points until testing/faults.py is
    ported."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.register_buffer("poison", torch.zeros(
            (), device=next(model.parameters()).device))

    def forward(self, *batch):
        return self.model(*batch) + self.poison


def phase_guarded(device, limit, cfg=None, run=None):
    """6h: guarded_step at a 2-layer cut of 7B: 3 clean guarded steps
    equal 3 plain steps bit for bit; a NaN-poisoned step and a step
    above the threshold leave every state tensor and the step count as
    they were."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models import (
        CompiledTrainStep, LlamaConfig, LlamaForCausalLM,
    )

    set_flags({"FLAGS_use_fused_rms_norm": True})
    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=2, recompute=True)
    run = dict(dict(batch=2, seq=2048), **(run or {}))
    steps = []
    for _ in range(2):
        model = Poisoned(LlamaForCausalLM(cfg, device=device, seed=4))
        steps.append(CompiledTrainStep(model, lr=1e-4,
                                       compute_dtype="bfloat16",
                                       device=device))
    plain, guarded = steps
    batch = _ids(cfg.vocab_size, run["batch"], run["seq"], device, seed=3)
    pl = [float(plain.step(*batch)) for _ in range(3)]
    gl = [guarded.guarded_step(float("inf"), *batch) for _ in range(3)]
    bad = _state_equal(plain, guarded)
    log(f"[guarded] 3 clean steps: plain losses {pl} | guarded "
        f"(loss, gnorm, ok) {gl} | state tensors that differ: {len(bad)}; "
        f"t {plain._t} / {guarded._t}")
    if bad or [g[0] for g in gl] != pl or not all(g[2] for g in gl) \
            or plain._t != guarded._t:
        raise AssertionError(f"[guarded] a clean guarded run is not the "
                             f"plain step: {bad[:4]}")
    for what, poison, ceiling in (("NaN loss", float("nan"), float("inf")),
                                  ("loss spike", 1e6, 1e3)):
        snap = guarded.state_dict()
        t0 = guarded._t
        guarded.model.poison.fill_(poison)
        out = guarded.guarded_step(ceiling, *batch)
        guarded.model.poison.zero_()
        changed = [f"{tree}[{k}]" for tree, name in
                   (("params", "params"), ("master", "_master"),
                    ("m", "_m"), ("v", "_v"))
                   for k, v in getattr(guarded, name).items()
                   if not torch.equal(v, snap[tree][k])]
        log(f"[guarded] {what} (threshold {ceiling}): (loss, gnorm, ok) "
            f"{out}, t {t0} -> {guarded._t}, state tensors changed "
            f"{len(changed)}")
        if out[2] or changed or guarded._t != t0:
            raise AssertionError(f"[guarded] the {what} step was not "
                                 f"skipped cleanly: {changed[:4]}")
    del plain, guarded, steps
    gc.collect()
    torch.cuda.empty_cache()


def _state_bytes(step):
    """Bytes of a train step's checkpoint: every state tensor and t."""
    return 8 + sum(t.numel() * t.element_size()
                   for tree in (step.params, step._master, step._m,
                                step._v)
                   for t in tree.values())


def _live_flat(step):
    """The train step's live state under the checkpoint's flat names (no
    copies): a load fills it in place."""
    from paddle_tpu_torch.training.guardian import _flatten_train_state

    return _flatten_train_state({"params": step.params,
                                 "master": step._master, "m": step._m,
                                 "v": step._v, "t": step._t})


def _flat_differs(flat, snap):
    """Names of the flat entries that differ bit for bit from ``snap``'s
    (any devices)."""
    return [k for k, v in snap.items()
            if not torch.equal(flat[k].cpu(), v.cpu())]


def _save_line(st, nbytes):
    def rate(sec):
        return f"{sec:.3f} s ({nbytes / max(sec, 1e-9) / 1e9:.2f} GB/s)"

    return (f"{st.files} files, {st.bytes} array bytes: device to host "
            f"{rate(st.snapshot_s)}, write {rate(st.write_s)}, fsync "
            f"{rate(st.fsync_s)}, crc32 {rate(st.crc_s)} summed over the "
            f"threads that run it beside the writes (the writer waited "
            f"{st.crc_wait_s:.3f} s for it)")


def phase_durable_train(device, limit, cfg=None, run=None):
    """6i (see the module docstring).  Returns {kernel: launches}."""
    import shutil

    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed.ckpt_commit import CheckpointManager
    from paddle_tpu_torch.models import (
        CompiledTrainStep, LlamaConfig, LlamaForCausalLM,
    )
    from paddle_tpu_torch.testing import faults
    from paddle_tpu_torch.training import GuardedTrainStep, GuardianPolicy
    from paddle_tpu_torch.training.guardian import _flatten_train_state

    set_flags({"FLAGS_use_fused_rms_norm": True})
    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=1, recompute=True)
    run = dict(dict(batch=2, seq=2048), **(run or {}))
    counters = _train_counters()

    def make(dev):
        model = LlamaForCausalLM(cfg, device=dev, seed=6)
        return CompiledTrainStep(model, lr=1e-4, compute_dtype="bfloat16",
                                 device=dev)

    step, clean = make(device), make(device)
    batches = [_ids(cfg.vocab_size, run["batch"], run["seq"], device,
                    seed=20 + i) for i in range(8)]
    nbytes = _state_bytes(step)
    n_params = sum(p.numel() for p in step.params.values())
    _zero_counts(counters)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-6i-") as tmp:
        free = shutil.disk_usage(tmp).free
        log(f"[6i] {cfg.num_hidden_layers} layer at 7B width: {n_params} "
            f"parameters, {nbytes} bytes a commit ({nbytes / 1e9:.3f} GB: "
            f"bf16 params, fp32 master, m, v); {free / 1e9:.1f} GB free "
            f"under {tmp}")
        if free < 2.5 * nbytes:
            raise AssertionError(f"[6i] {free} bytes free for two commits "
                                 f"of {nbytes}")
        mgr = CheckpointManager(tmp, keep_last_k=2)
        g = GuardedTrainStep(step, manager=mgr, commit_initial=False,
                             policy=GuardianPolicy(
                                 window=8, min_history=2, skip_budget=1,
                                 rollback_budget=2, checkpoint_every=2))
        decisions = []

        def gstep():
            _, d = g.step(*batches[g.global_step])
            decisions.append(d.value)

        gstep()
        t0 = time.perf_counter()
        gstep()                 # accepted: the guardian commits step 2
        commit_s = time.perf_counter() - t0
        if mgr.committed_steps() != [2]:
            raise AssertionError(f"[6i] commits {mgr.committed_steps()}")
        log(f"[6i] commit of step 2 (synchronous, inside the step: "
            f"{commit_s:.3f} s with the step): "
            f"{_save_line(ckpt.last_save_stats(), nbytes)}")
        snap = {k: v.clone() for k, v in _live_flat(step).items()}
        # the uninterrupted run: three clean steps
        ref = [float(clean.step(*batches[i])) for i in range(3)]
        faults.reset("guard.loss_spike:before:1=inject:1e6")
        gstep()                 # a spike: skipped
        faults.reset("guard.nan_loss:before:1=inject")
        t0 = time.perf_counter()
        gstep()                 # NaN: past the skip budget, rollback
        rollback_s = time.perf_counter() - t0
        faults.reset("")
        st = ckpt.last_load_stats()
        diff = _flat_differs(_live_flat(step), snap)
        log(f"[6i] decisions {decisions}; rollback to step "
            f"{g.global_step} in {rollback_s:.3f} s with the step; the "
            f"load: {st.seconds:.3f} s ({st.total_read_bytes / st.seconds / 1e9:.2f} "
            f"GB/s, crc32 checked first), peak buffer "
            f"{st.peak_buffer_bytes} bytes over {st.regions} tensors; state "
            f"entries that differ from the commit's snapshot: {len(diff)}")
        if decisions != ["ok", "ok", "skip", "rollback"] or diff \
                or g.global_step != 2:
            raise AssertionError(f"[6i] the rollback: {decisions}, "
                                 f"{diff[:4]}")
        del snap
        loss, d = g.step(*batches[2])
        bad = _state_equal(step, clean)
        log(f"[6i] the next clean step: loss {loss} (uninterrupted run "
            f"{ref[2]}), state tensors that differ {len(bad)}")
        if d.value != "ok" or loss != ref[2] or bad or step._t != clean._t:
            raise AssertionError(f"[6i] the resumed step is not the "
                                 f"uninterrupted one: {bad[:4]}")
        del clean
        gc.collect()
        _empty(device)
        # an async commit, steps running while it writes
        g.guardian.policy.checkpoint_every = None
        _, alone = _timed(device, lambda: [g.step(*batches[i])
                                           for i in (3, 4)])
        flat = _flatten_train_state(step.state_dict())
        t0 = time.perf_counter()
        handle = mgr.save(flat, g.global_step, async_save=True)
        call_s = time.perf_counter() - t0
        stats = ckpt.last_save_stats()
        _, during = _timed(device, lambda: [g.step(*batches[i])
                                            for i in (5, 6)])
        handle.result()
        total_s = time.perf_counter() - t0
        saved = mgr.latest_step()
        log(f"[6i] async commit of step {saved}: the call {call_s:.3f} s "
            f"(the copy to the host), committed after {total_s:.3f} s; "
            f"{_save_line(stats, nbytes)}; a step "
            f"{alone / 2:.1f} ms alone, {during / 2:.1f} ms while the "
            f"save writes | {limit}")
        launches = _counts(counters)
        # the commit of CUDA tensors, loaded into a CPU train step
        t0 = time.perf_counter()
        cpu_step = make("cpu")
        build_s = time.perf_counter() - t0
        into = _live_flat(cpu_step)
        mgr.load(into, step=saved)
        cpu_step._t = int(into["t"])
        st = ckpt.last_load_stats()
        diff = _flat_differs(into, flat)
        log(f"[6i] step {saved}'s commit loaded into a CPU train step "
            f"(built in {build_s:.1f} s): {st.seconds:.3f} s "
            f"({st.total_read_bytes / st.seconds / 1e9:.2f} GB/s), entries "
            f"that differ from the card's state {len(diff)}; commits on "
            f"disk {mgr.committed_steps()}")
        if diff or mgr.committed_steps() != [2, saved]:
            raise AssertionError(f"[6i] the CPU load differs: {diff[:4]}")
        del cpu_step, into, flat
    log(f"[6i] launches {launches}")
    for k in ("rms_norm_fwd", "rms_norm_bwd", "attention_fwd",
              "attention_bwd"):
        if device.type == "cuda" and not launches[k]:
            raise AssertionError(f"[6i] {k} never launched")
    del step, g
    gc.collect()
    _empty(device)
    return launches


def phase_bert_graph(device, limit, cfg=None, run=None):
    """8c: BERT-base QA (phase 8's config) through multi_step(4) against
    4 eager steps: bit for bit with dropout 0, the ms per step and the
    idle share both ways; with dropout 0.1 and lr 0 (the state stays as
    it is), two replays must draw different masks (different losses)."""
    from paddle_tpu_torch.models import BertConfig, CompiledTrainStep
    from paddle_tpu_torch.nn.common import embedding_grad

    run = dict(BERT_RUN, **(run or {}))
    B, S, k = run["batch"], run["seq"], 4
    base = cfg or BertConfig.base()
    # the token-type table's backward (one id B*S times, fp32), 20 times:
    # the library's against the port's embedding_grad
    ids = torch.zeros(B, S, dtype=torch.long, device=device)
    g = torch.randn(B, S, base.hidden_size, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    w = torch.zeros(2, base.hidden_size, device=device, requires_grad=True)
    lib = [torch.autograd.grad(torch.nn.functional.embedding(ids, w), w,
                               g)[0] for _ in range(20)]
    ours = [embedding_grad(ids, g, 2, torch.float32) for _ in range(20)]
    spread = {name: max(float((x - runs[0]).abs().max()) for x in runs)
              for name, runs in (("library", lib), ("port", ours))}
    log(f"[bert-graph] embedding backward, one id {B * S} times, fp32, 20 "
        f"runs: largest difference from the first run: library "
        f"{spread['library']:.3e}, port {spread['port']:.3e}; port vs "
        f"library {float((ours[0] - lib[0]).abs().max()):.3e}")
    if spread["port"] != 0.0:
        raise AssertionError("[bert-graph] embedding_grad is not repeatable")
    del lib, ours, g
    c0 = BertConfig(**{**base.__dict__, "hidden_dropout_prob": 0.0,
                       "attention_probs_dropout_prob": 0.0})
    steps = []
    for _ in range(2):
        model = QATrain(c0, device)
        model.train()
        steps.append(CompiledTrainStep(model, lr=run["lr"],
                                       compute_dtype="bfloat16",
                                       device=device))
    eager, graph = steps
    batch = _bert_batch(c0.vocab_size, B, S, device)
    res = []
    for rnd in range(2):
        el, ems = _timed(device, lambda: [float(eager.step(*batch))
                                          for _ in range(k)])
        _, gms = _timed(device, lambda: graph.multi_step(k, *batch))
        gl = graph.last_losses.tolist()
        bad = _state_equal(eager, graph)
        res.append((el == gl and not bad, ems / k, gms / k))
        log(f"[bert-graph] dropout 0, round {rnd}: eager losses {el} | "
            f"graph losses {gl} | state tensors that differ {len(bad)}"
            f"{' ' + str(bad[:4]) if bad else ''}")
    ew, eb = _traced(lambda: [eager.step(*batch) for _ in range(k)])
    gw, gb = _traced(lambda: graph.multi_step(k, *batch))
    log(f"[bert-graph] B={B} S={S}: eager {res[1][1]:.1f} ms a step, "
        f"multi_step({k}) {res[1][2]:.1f} ms a step (round 0 with capture "
        f"{res[0][2]:.1f}) | traced {k} steps: eager wall {ew:.1f} ms, busy "
        f"{eb:.1f} ms, idle share {1 - eb / ew:.3f}; graph wall {gw:.1f} ms, "
        f"busy {gb:.1f} ms, idle share {1 - gb / gw:.3f} | {limit}")
    if not all(r[0] for r in res):
        raise AssertionError("[bert-graph] multi_step is not the eager "
                             "steps bit for bit at dropout 0")
    del eager, graph, steps
    gc.collect()
    model = QATrain(base, device)
    model.train()
    step = CompiledTrainStep(model, lr=0.0, compute_dtype="bfloat16",
                             device=device)
    draws = [float(step.multi_step(1, *batch)) for _ in range(3)]
    log(f"[bert-graph] dropout {base.hidden_dropout_prob} / "
        f"{base.attention_probs_dropout_prob}, lr 0: losses of three "
        f"replays {draws} (a repeated loss would mean a repeated mask)")
    if len(set(draws)) != len(draws) or not all(np.isfinite(draws)):
        raise AssertionError("[bert-graph] replays repeat their dropout "
                             f"masks: {draws}")
    del step, model
    gc.collect()
    _empty(device)
    # remat=True under capture: the recompute draws each mask again from
    # its generator's twin; at lr 0 the parameters stay, the moments take
    # each step's gradients, so equal states mean equal gradients
    steps = []
    for _ in range(2):
        model = QATrain(base, device)
        model.train()
        steps.append(CompiledTrainStep(model, lr=0.0, remat=True,
                                       compute_dtype="bfloat16",
                                       device=device))
    eager, graph = steps
    counters = {k: f for k, f in _train_counters().items()
                if k.startswith("short")}
    el, gl, replayed = [], [], []
    for _ in range(3):
        el.append(float(eager.step(*batch)))
        _zero_counts(counters)
        gl.append(float(graph.multi_step(1, *batch)))
        replayed.append(_counts(counters))
    bad = _state_equal(eager, graph)
    log(f"[bert-graph] remat=True, dropout {base.hidden_dropout_prob}, lr "
        f"0: eager losses {el} | replayed losses {gl} (the first call "
        f"captures) | state tensors that differ {len(bad)} | short "
        f"attention launches a replay {replayed[1:]}")
    if el != gl or bad or len(set(gl)) != len(gl) \
            or not all(np.isfinite(gl)):
        raise AssertionError(f"[bert-graph] remat under capture: {bad[:4]}")
    if device.type == "cuda" and not all(
            r["short_attention_fwd"] and r["short_attention_bwd"]
            for r in replayed[1:]):
        raise AssertionError(f"[bert-graph] replays launched {replayed}")
    del eager, graph, steps, model
    gc.collect()
    _empty(device)


# -- phase 3e: the short-attention kernels -------------------------------------

def short_attention_bounds(B, H, S, D, elem_bytes, causal=False):
    """(fwd, bwd) (bound_ms, bound_by): 4·B·H·S²·D flops forward and
    10·B·H·S²·D backward (two and five [S, S, D] products), halved when
    causal, over the bf16 tensor-core rate (fp32 inputs: the fp32 rate),
    against the function's inputs read and outputs written once (fwd: q,
    k, v in, out and lse out; bwd: q, k, v, g and lse in, dq, dk, dv
    out) over HBM rate."""
    rate = BF16_FLOPS if elem_bytes == 2 else FP32_FLOPS
    one = B * H * S * D * elem_bytes
    frac = 0.5 if causal else 1.0
    out = []
    for flops, nbytes in ((4, 4 * one + 4 * B * H * S),
                          (10, 7 * one + 4 * B * H * S)):
        to = flops * B * H * S * S * D * frac / rate * 1e3
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        out.append((to, "operations") if to >= tb else (tb, "bytes"))
    return out


#: (label, B, H, S, D, dtype, causal, dropout_p)
SHORT_CASES = [
    ("bert-base p=0.1", 48, 12, 384, 64, torch.bfloat16, False, 0.1),
    ("bert-base p=0", 48, 12, 384, 64, torch.bfloat16, False, 0.0),
    ("bert-width fp32 p=0.1", 4, 12, 384, 64, torch.float32, False, 0.1),
    ("llama S=512 causal", 4, 32, 512, 128, torch.bfloat16, True, 0.0),
    ("S=1024 causal p=0.1", 2, 4, 1024, 128, torch.bfloat16, True, 0.1),
    ("S=128 causal p=0.5 fp32", 2, 4, 128, 64, torch.float32, True, 0.5),
]


def phase_short_kernels(device, iters=20):
    """Both short-attention kernels against their plain versions on the
    card at the BERT, Llama S=512 and edge shapes, the dropout mask held
    exactly, then timed at the BERT shape.  Returns their two rows."""
    from paddle_tpu_torch.ops.kernels import short_attention as sa

    F = torch.nn.functional
    gen = torch.Generator(device=device)
    gen.manual_seed(8642)
    f32 = torch.float32
    before = (sa.short_attention_fwd.launches,
              sa.short_attention_bwd.launches)
    seed = torch.tensor([-1234567891], dtype=torch.int32, device=device)
    errs = {"fwd": 0.0, "bwd": 0.0}
    kernel_ms = {}
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=device)
    for label, B, H, S, D, dt, causal, p in SHORT_CASES:
        q, k, v, g = (torch.randn(B, H, S, D, generator=gen, device=device)
                      .to(dt) for _ in range(4))
        scale = 1.0 / np.sqrt(D)
        out, lse, out32 = sa.short_attention_fwd(q, k, v, seed, scale, p,
                                                 causal)
        grads = sa.short_attention_bwd(q, k, v, out32, lse, g, seed, scale,
                                       p, causal)
        torch.cuda.synchronize()
        wout, wlse, wout32 = sa.short_attention_fwd_reference(
            q, k, v, seed, scale, p, causal)
        tag = f"{label} [{B}, {H}, {S}, {D}] {dt}"
        if not torch.equal(out == 0, wout == 0):
            raise AssertionError(f"[kernels] short_attention_fwd {tag}: the "
                                 "zeros of out differ from the plain "
                                 "version's (another dropout mask)")
        if dt == f32:
            tol, why = (2e-5, 0.0), "fp32 throughout, other summation order"
            gtol, gwhy = (1e-4, 0.0), why
        else:
            tol, why = (2e-3, 2 ** -7), BF16_WHY
            gtol = (5e-3, 2 ** -6)
            gwhy = f"bf16 outputs of sums over up to {S} fp32 terms"
        e = _hold(f"short_attention_fwd out {tag}", out, wout, *tol, why)
        _hold(f"short_attention_fwd out32 {tag}", out32, wout32, 2e-5, 0.0,
              "fp32 from the same widened inputs, other summation order")
        _hold(f"short_attention_fwd lse {tag}", lse, wlse, 2e-5, 0.0,
              "fp32, other summation order")
        errs["fwd"] = max(errs["fwd"], e)
        del wout, wlse, wout32
        torch.cuda.empty_cache()
        wgrads = sa.short_attention_bwd_reference(q, k, v, out32, lse, g,
                                                  seed, scale, p, causal)
        for n, a, w_ in zip(("dq", "dk", "dv"), grads, wgrads):
            errs["bwd"] = max(errs["bwd"], _hold(
                f"short_attention_bwd {n} {tag}", a, w_, *gtol, gwhy))
        del wgrads
        kernel_ms[label] = (
            time_ms(lambda: sa.short_attention_fwd(q, k, v, seed, scale, p,
                                                   causal), flush, iters),
            time_ms(lambda: sa.short_attention_bwd(q, k, v, out32, lse, g,
                                                   seed, scale, p, causal),
                    flush, iters))
        fb, bb = short_attention_bounds(B, H, S, D, q.element_size(), causal)
        log(f"[kernels] short_attention time at {tag} causal={causal} "
            f"p={p}: fwd {kernel_ms[label][0]:.4f} ms (bound {fb[0]:.4f}, "
            f"{100 * fb[0] / kernel_ms[label][0]:.1f}%), bwd "
            f"{kernel_ms[label][1]:.4f} ms (bound {bb[0]:.4f}, "
            f"{100 * bb[0] / kernel_ms[label][1]:.1f}%)")
        del q, k, v, g, out, lse, out32, grads
        torch.cuda.empty_cache()

    f1, b1 = kernel_ms["bert-base p=0.1"]
    f0, b0 = kernel_ms["bert-base p=0"]
    log(f"[kernels] short_attention mask cost at [48, 12, 384, 64] bf16: "
        f"fwd {f1:.4f} ms at p=0.1 vs {f0:.4f} ms at p=0 "
        f"({100 * (f1 / f0 - 1):+.1f}%), bwd {b1:.4f} vs {b0:.4f} ms "
        f"({100 * (b1 / b0 - 1):+.1f}%)")

    # the mask itself: v = I makes out the dropped probability matrix, and
    # g = I makes dv its transpose
    S = D = 128
    q, k = (torch.randn(2, 4, S, D, generator=gen, device=device)
            for _ in range(2))
    eye = torch.eye(S, device=device).expand(2, 4, S, S).contiguous()
    out, lse, out32 = sa.short_attention_fwd(q, k, eye, seed, 1 / np.sqrt(D),
                                             0.5, False)
    _, _, dv = sa.short_attention_bwd(q, k, eye, out32, lse, eye, seed,
                                      1 / np.sqrt(D), 0.5, False)
    torch.cuda.synchronize()
    wout, _, _ = sa.short_attention_fwd_reference(q, k, eye, seed,
                                                  1 / np.sqrt(D), 0.5, False)
    _, _, wdv = sa.short_attention_bwd_reference(q, k, eye, out32, lse, eye,
                                                 seed, 1 / np.sqrt(D), 0.5,
                                                 False)
    keep = sa.keep_mask(seed, 2, 4, S, 0.5)
    ok = (torch.equal(out == 0, wout == 0) and torch.equal(out == 0, ~keep)
          and torch.equal(dv == 0, wdv == 0)
          and torch.equal(dv == 0, ~keep.transpose(-1, -2)))
    log(f"[kernels] short_attention dropout mask at S = D = 128, p = 0.5, "
        f"seed {int(seed)}: zeros of out (v = I) and of dv (g = I) equal "
        f"the plain version's exactly: {ok} (kept share "
        f"{keep.float().mean().item():.4f})")
    if not ok:
        raise AssertionError("[kernels] short_attention: the kernel's "
                             "dropout mask differs from the plain version's")

    # timing at the BERT shape, bf16, p = 0.1: kernel, plain, SDPA
    label, B, H, S, D, dt, causal, p = SHORT_CASES[0]
    q, k, v, g = (torch.randn(B, H, S, D, generator=gen, device=device)
                  .to(dt) for _ in range(4))
    scale = 1.0 / np.sqrt(D)
    out, lse, out32 = sa.short_attention_fwd(q, k, v, seed, scale, p, causal)
    ql, kl, vl = (a.detach().requires_grad_(True) for a in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, dropout_p=p)
    times = {
        "short_attention_fwd": [time_ms(f, flush, iters) for f in (
            lambda: sa.short_attention_fwd(q, k, v, seed, scale, p, causal),
            lambda: sa.short_attention_fwd_reference(q, k, v, seed, scale, p,
                                                     causal),
            lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=p))],
        "short_attention_bwd": [time_ms(f, flush, iters) for f in (
            lambda: sa.short_attention_bwd(q, k, v, out32, lse, g, seed,
                                           scale, p, causal),
            lambda: sa.short_attention_bwd_reference(
                q, k, v, out32, lse, g, seed, scale, p, causal),
            lambda: torch.autograd.grad(ol, (ql, kl, vl), g,
                                        retain_graph=True))],
    }
    del q, k, v, g, out, lse, out32, ql, kl, vl, ol, flush
    torch.cuda.empty_cache()
    sa.short_attention_fwd.launches, sa.short_attention_bwd.launches = before

    bounds = short_attention_bounds(B, H, S, D, 2, causal)
    lib = {"short_attention_fwd": "scaled_dot_product_attention, "
                                  f"dropout_p={p}, its own RNG",
           "short_attention_bwd": "autograd of scaled_dot_product_attention"
                                  f" with dropout_p={p}"}
    rows = []
    for (name, (ms, plain_ms, library_ms)), (bound, by), line in zip(
            times.items(), bounds, (139, 163)):
        log(f"[kernels] {name} time at [{B}, {H}, {S}, {D}] bf16 p={p}: "
            f"kernel {ms:.4f} ms | bound {bound:.4f} ms ({by}) | plain "
            f"{plain_ms:.4f} ms | library_ms {library_ms:.4f} ms "
            f"({lib[name]}) | {100 * bound / ms:.1f}% of bound")
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/csrc/short_attention.cu",
                     "replaces": "paddle_tpu/ops/pallas_kernels/"
                                 f"short_attention.py:{line}",
                     "max_abs_err": errs[name[-3:]], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": library_ms})
    return rows


# -- phase 8: BERT-base SQuAD fine-tuning ---------------------------------------

BERT_RUN = dict(batch=48, seq=384, steps=5, lr=3e-5)


class QATrain(torch.nn.Module):
    """bench.py's QA wrapper: ``(ids, starts, ends) -> loss``."""

    def __init__(self, cfg, device, seed=0):
        super().__init__()
        from paddle_tpu_torch.models import BertForQuestionAnswering

        self.qa = BertForQuestionAnswering(cfg, device=device, seed=seed)

    def forward(self, ids, starts, ends):
        return self.qa(ids, start_positions=starts, end_positions=ends)


def _bert_batch(vocab, B, S, device, seed=0):
    """ids and span labels as bench.py draws them (int32)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.int32)
    starts = rng.randint(0, S, (B,)).astype(np.int32)
    ends = rng.randint(0, S, (B,)).astype(np.int32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (ids, starts, ends))


def phase_bert_train(device, limit, cfg=None, run=None):
    """BERT-base QA fine-tuning at bench.py's settings: one warm-up step
    and ``steps`` timed ones.  Returns ({kernel: launches over all
    steps}, step, batch)."""
    from paddle_tpu_torch.models import BertConfig, CompiledTrainStep

    cfg = cfg or BertConfig.base()
    run = dict(BERT_RUN, **(run or {}))
    B, S, n = run["batch"], run["seq"], run["steps"]
    L = cfg.num_hidden_layers
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    model = QATrain(cfg, device)
    model.train()
    step = CompiledTrainStep(model, lr=run["lr"], compute_dtype="bfloat16",
                             device=device)
    bert = model.qa.bert
    batch = _bert_batch(cfg.vocab_size, B, S, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log(f"[bert] {L} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads, D "
        f"{cfg.hidden_size // cfg.num_attention_heads}, intermediate "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}: "
        f"{bert.num_params() / 1e6:.3f} M encoder parameters, bf16 compute, "
        f"fp32 master and moments, dropout {cfg.hidden_dropout_prob} / "
        f"{cfg.attention_probs_dropout_prob}, remat off, built in "
        f"{time.perf_counter() - t0:.1f} s")
    counters = _train_counters()
    per_step = {k: 0 for k in counters}
    per_step.update(short_attention_fwd=L, short_attention_bwd=L)
    for f in counters.values():
        f.launches = 0
    losses, step_ms = [], []
    for i in range(n + 1):
        before = {k: f.launches for k, f in counters.items()}
        t1 = time.perf_counter()
        loss = float(step.step(*batch))       # float() synchronises
        ms = (time.perf_counter() - t1) * 1e3
        losses.append(loss)
        if i:
            step_ms.append(ms)
        got = {k: f.launches - before[k] for k, f in counters.items()}
        log(f"[bert] step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{loss:.6f}, {ms:.1f} ms, short-attention launches "
            f"{got['short_attention_fwd']} fwd / {got['short_attention_bwd']}"
            f" bwd")
        if on_card and got != per_step:
            raise AssertionError(f"[bert] step {i} launched {got}, expected "
                                 f"{per_step} (one short-attention forward "
                                 f"and backward per layer, no remat)")
    launches = {k: f.launches for k, f in counters.items()}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[bert] losses {losses}: not all finite")
    mean_ms = float(np.mean(step_ms))
    tokens = B * S
    fpt = bert.flops_per_token(S)
    mfu = fpt * tokens / (mean_ms / 1e3) / BF16_FLOPS
    peak = (torch.cuda.max_memory_allocated() / 2**30 if on_card
            else float("nan"))
    log(f"[bert] B={B} S={S}: step {mean_ms:.1f} ms (mean of {n}; "
        f"{', '.join(f'{m:.1f}' for m in step_ms)}) | "
        f"{B / (mean_ms / 1e3):.1f} sequences/s | "
        f"{tokens / (mean_ms / 1e3):.1f} tokens/s | MFU {mfu:.4f} "
        f"(6N + 12LhS = {fpt:.4e} flops/token over "
        f"{BF16_FLOPS / 1e12:g} TFLOP/s bf16) | peak memory {peak:.2f} GiB | "
        f"losses {losses} | {limit}")
    return launches, step, batch


def phase_bert_profile(step, batch):
    """One traced BERT step: device time of the short kernels, cuBLAS,
    the forward's LayerNorms and dropouts, AdamW and the rest, and the
    idle share.  LayerNorm, dropout and the AdamW update are marked with
    ``record_function`` ranges for the traced step only."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.ops import nn_ops

    counters = _train_counters()
    saved = {k: f.launches for k, f in counters.items()}
    real = {"layer_norm": nn_ops.layer_norm, "dropout": nn_ops.dropout}

    def ranged(name, fn):
        def f(*a, **kw):
            with record_function(f"smoke::{name}"):
                return fn(*a, **kw)
        return f

    update = step._update
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for name, fn in real.items():
            setattr(nn_ops, name, ranged(name, fn))
            stack.callback(setattr, nn_ops, name, fn)
        step._update = ranged("adamw", update)
        stack.callback(delattr, step, "_update")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step.step(*batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    for k, f in counters.items():        # the traced step does not count
        f.launches = saved[k]
    kinds = {"short_attention_fwd": 0.0, "short_attention_bwd": 0.0,
             "gemm": 0.0, "other": 0.0}
    ranges = {"layer_norm": 0.0, "dropout": 0.0, "adamw": 0.0}
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.key.startswith("smoke::"):     # the CPU-side range only
            if ev.device_type == torch.autograd.DeviceType.CPU:
                ranges[ev.key[7:]] += ev.device_time_total / 1e3
            continue
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        name = ev.key.lower()
        kind = ("short_attention_fwd" if "sattn_fwd" in name else
                "short_attention_bwd" if ("sattn_bwd" in name
                                          or "sattn_delta" in name) else
                "gemm" if any(k in name for k in ("gemm", "cutlass", "xmma",
                                                  "nvjet", "sm90_"))
                else "other")
        kinds[kind] += ms
        per_kernel[ev.key[:60]] = (ms, ev.count)
    busy = sum(kinds.values())
    log(f"[profile-bert] one step traced: {wall:.1f} ms wall | device busy "
        f"{busy:.1f} ms ({', '.join(f'{k} {v:.1f}' for k, v in kinds.items())}"
        f"; of 'other': forward LayerNorm {ranges['layer_norm']:.1f}, "
        f"forward dropout {ranges['dropout']:.1f}, AdamW "
        f"{ranges['adamw']:.1f}) | idle share {1 - busy / wall:.3f}")
    for name, (ms, calls) in sorted(per_kernel.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile-bert]   {ms:9.2f} ms  {calls:5d} launches  {name}")


def phase_bert_parity(device, steps=3):
    """The same BERT weights trained on the card (the short kernel) and
    on the CPU (the einsum path), fp32, dropout 0."""
    from paddle_tpu_torch.models import BertConfig, CompiledTrainStep

    cfg = BertConfig(vocab_size=4096, hidden_size=256, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=1024,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    counters = _train_counters()
    losses = {}
    for dev in (device, torch.device("cpu")):
        model = QATrain(cfg, "cpu", seed=3)
        step = CompiledTrainStep(model, lr=1e-3, device=dev)
        before = {k: f.launches for k, f in counters.items()}
        batch = _bert_batch(cfg.vocab_size, 2, 256, dev, seed=1)
        losses[dev.type] = [float(step.step(*batch)) for _ in range(steps)]
        launched = {k: f.launches - before[k] for k, f in counters.items()}
        log(f"[bert-parity] {dev.type}: losses {losses[dev.type]}, kernel "
            f"launches {launched}")
        if dev.type == "cuda" and not (
                launched["short_attention_fwd"]
                == launched["short_attention_bwd"]
                == steps * cfg.num_hidden_layers):
            raise AssertionError("[bert-parity] the card run did not take "
                                 f"the short kernel: {launched}")
    got, want = np.array(losses[device.type]), np.array(losses["cpu"])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    log(f"[bert-parity] {steps} fp32 steps, 2 layers, hidden 256, 4 heads, "
        f"S=256: max relative loss difference card vs CPU {rel:.3e} (limit "
        f"1e-4: fp32 on both, TF32 off, other summation orders)")
    if not rel <= 1e-4:
        raise AssertionError(f"[bert-parity] losses differ: {losses}")


# -- phase 3f: the grouped expert FFN kernels ----------------------------------

#: bench.py's `moe` config (bench.py:1832-1939): d_model, experts, top-k,
#: FFN width, tokens, capacity factor
MOE = dict(H=2048, E=8, k=2, F=5504, T=8192, cf=1.25)


def moe_capacity(T, E=MOE["E"], k=MOE["k"], cf=MOE["cf"]):
    """Slots per expert, on the host as both packages compute it."""
    return min(T, max(1, int(np.ceil(T * cf * k / E))))


def grouped_ffn_bound(E, C, H, F, x_bytes, w_bytes, scales=False):
    """(bound_ms, bound_by): 4·E·C·H·F flops over the bf16 tensor-core
    rate (fp32 x: the fp32 rate) against x, weights, biases, scales and
    out moved once over HBM rate."""
    rate = FP32_FLOPS if x_bytes == 4 else BF16_FLOPS
    nbytes = (2 * E * C * H * x_bytes + 2 * E * H * F * w_bytes
              + E * (F + H) * (x_bytes + (4 if scales else 0)))
    to = 4 * E * C * H * F / rate * 1e3
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    return (to, "operations") if to >= tb else (tb, "bytes")


#: (label, E, C, H, F, dtype, activation, impl forced)
GROUPED_CASES = [
    ("bench bucket", 8, 2560, 2048, 5504, torch.bfloat16, "gelu", None),
    ("decode C=20 (T=64)", 8, 20, 2048, 5504, torch.bfloat16, "gelu", None),
    ("fp32", 4, 256, 256, 512, torch.float32, "gelu", None),
    ("relu", 4, 256, 512, 1024, torch.bfloat16, "relu", None),
    ("silu", 4, 256, 512, 1024, torch.bfloat16, "silu", None),
    ("C=130", 8, 130, 1024, 768, torch.bfloat16, "gelu", None),
    ("tiny", 2, 7, 8, 8, torch.bfloat16, "silu", None),
    ("tiny fp32", 2, 7, 8, 8, torch.float32, "silu", None),
    ("H, F not multiples of 128", 4, 64, 200, 300, torch.bfloat16, "gelu",
     "pallas"),
    ("H > 2048, F ragged, fp32", 2, 40, 2176, 200, torch.float32, "tanh",
     "pallas"),
]
GROUPED_Q_CASES = [("int8 bench bucket", 8, 2560), ("int8 decode C=20", 8, 20)]
#: (E, C, H, F) of the int8 case off the multiples of 128 (and of 16)
GROUPED_Q_RAGGED = (4, 64, 200, 300)


def _time_halves(gg, args, act, flush, iters):
    """Milliseconds of GEMM 1 alone and GEMM 2 alone of the tensor-core
    route on ``args`` (x, w1, s1, b1, w2, s2, b2)."""
    return tuple(time_ms(lambda p=p: gg._launch(*args, act, "halves",
                                                passes=p), flush, iters)
                 for p in (1, 2))


def _moe_weights(gen, E, H, F, dtype, device, scale=0.02):
    w1 = (torch.randn(E, H, F, generator=gen, device=device) * scale)
    w2 = (torch.randn(E, F, H, generator=gen, device=device) * scale)
    b1 = torch.randn(E, 1, F, generator=gen, device=device) * scale
    b2 = torch.randn(E, 1, H, generator=gen, device=device) * scale
    return [t.to(dtype) for t in (w1, b1, w2, b2)]


def _hold_grouped(label, got, want):
    if want.dtype == torch.float32:
        atol = 1e-5 * want.abs().max().item()
        return _hold(label, got, want, atol, 1e-5,
                     "fp32 sums of up to 2048 products in another order")
    atol = 1e-3 * want.float().abs().max().item()
    return _hold(label, got, want, atol, 2 ** -7, BF16_WHY)


def phase_grouped_kernels(device, iters=10):
    """Kernels 10 and 11 against their plain versions on the card at the
    MoE bench shape, a decode-sized C, fp32, other activations and ragged
    edges, each timed beside its bound, the plain version and the einsum
    route (the library call).  Returns their two rows."""
    from paddle_tpu_torch.ops import quant as tq
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg

    gen = torch.Generator(device=device)
    gen.manual_seed(97531)
    before = (gg.grouped_ffn.launches, gg.grouped_ffn_q.launches)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=device)
    errs, timed, halves = {"grouped_ffn": 0.0, "grouped_ffn_q": 0.0}, {}, {}
    bench_w = None
    for label, E, C, H, F, dt, act, impl in GROUPED_CASES:
        x = torch.randn(E, C, H, generator=gen, device=device).to(dt)
        w1, b1, w2, b2 = _moe_weights(gen, E, H, F, dt, device)
        if impl is None:
            got = gg.grouped_ffn_fwd(x, w1, b1, w2, b2, act)
        else:       # through the router, the kernel route forced
            got = gg.grouped_ffn(x, w1, b1, w2, b2, act, impl=impl)
        torch.cuda.synchronize()
        want = gg.grouped_ffn_reference(x, w1, b1, w2, b2, act)
        tag = f"{label} [{E}, {C}, {H}] x F={F} {dt} {act}"
        errs["grouped_ffn"] = max(errs["grouped_ffn"], _hold_grouped(
            f"grouped_ffn {tag}", got, want))
        if label in ("bench bucket", "decode C=20 (T=64)", "fp32"):
            timed[("grouped_ffn", label)] = (
                [time_ms(f, flush, iters) for f in (
                    lambda: gg.grouped_ffn_fwd(x, w1, b1, w2, b2, act),
                    lambda: gg.grouped_ffn_reference(x, w1, b1, w2, b2, act),
                    lambda: gg.einsum_ffn(x, w1, b1, w2, b2, act))],
                grouped_ffn_bound(E, C, H, F, x.element_size(),
                                  w1.element_size()), tag)
        if label == "bench bucket":
            bench_w = (w1, b1, w2, b2)
            halves[("grouped_ffn", label)] = _time_halves(
                gg, (x, w1, None, b1, w2, None, b2), act, flush, iters)
        del x, got, want
        if label != "bench bucket":
            del w1, b1, w2, b2
        torch.cuda.empty_cache()

    # kernel 11 over the bench weights quantized, bf16 x
    w1, b1, w2, b2 = bench_w
    q1, q2 = tq.quantize_linear(w1), tq.quantize_linear(w2)
    dq1 = tq.dequantize(q1["qweight"], q1["scale"], torch.bfloat16)
    dq2 = tq.dequantize(q2["qweight"], q2["scale"], torch.bfloat16)
    del bench_w, w1, w2
    for label, E, C in GROUPED_Q_CASES:
        H, F = MOE["H"], MOE["F"]
        x = torch.randn(E, C, H, generator=gen, device=device).bfloat16()
        args = (x, q1["qweight"], q1["scale"], b1, q2["qweight"],
                q2["scale"], b2)
        got = gg.grouped_ffn_q(*args)
        torch.cuda.synchronize()
        want = gg.grouped_ffn_q_reference(*args)
        tag = f"{label} [{E}, {C}, {H}] x F={F} bf16 gelu"
        errs["grouped_ffn_q"] = max(errs["grouped_ffn_q"], _hold_grouped(
            f"grouped_ffn_q {tag}", got, want))
        timed[("grouped_ffn_q", label)] = (
            [time_ms(f, flush, iters) for f in (
                lambda: gg.grouped_ffn_q(*args),
                lambda: gg.grouped_ffn_q_reference(*args),
                lambda: gg.einsum_ffn(x, dq1, b1, dq2, b2))],
            grouped_ffn_bound(E, C, H, F, 2, 1, scales=True), tag)
        if label == "int8 bench bucket":
            halves[("grouped_ffn_q", label)] = _time_halves(
                gg, args, "gelu", flush, iters)
        del x, args, got, want
        torch.cuda.empty_cache()
    del q1, q2, dq1, dq2, flush
    torch.cuda.empty_cache()

    # int8 weights whose H and F TMA cannot describe unpadded, through the
    # router with the kernel route forced (the wrapper zero-pads them)
    E, C, H, F = GROUPED_Q_RAGGED
    x = torch.randn(E, C, H, generator=gen, device=device).bfloat16()
    w1, b1, w2, b2 = _moe_weights(gen, E, H, F, torch.float32, device)
    q1, q2 = tq.quantize_linear(w1), tq.quantize_linear(w2)
    got = gg.grouped_ffn(x, q1, b1, q2, b2, "sigmoid", impl="pallas")
    torch.cuda.synchronize()
    want = gg.grouped_ffn_q_reference(x, q1["qweight"], q1["scale"], b1,
                                      q2["qweight"], q2["scale"], b2,
                                      "sigmoid")
    errs["grouped_ffn_q"] = max(errs["grouped_ffn_q"], _hold_grouped(
        f"grouped_ffn_q int8, H and F not multiples of 128 [{E}, {C}, {H}] "
        f"x F={F} bf16 sigmoid, impl=pallas", got, want))
    del x, w1, b1, w2, b2, q1, q2, got, want
    gg.grouped_ffn.launches, gg.grouped_ffn_q.launches = before

    lib = {"grouped_ffn": "einsum_ffn: torch.bmm + bias + activation + "
                          "torch.bmm in x's dtype",
           "grouped_ffn_q": "einsum_ffn over the weights dequantized to "
                            "bf16 beforehand"}
    for (name, label), ((ms, plain, library), (bound, by), tag) in \
            timed.items():
        log(f"[kernels] {name} time at {tag}: kernel {ms:.4f} ms | bound "
            f"{bound:.4f} ms ({by}) | plain {plain:.4f} ms | library_ms "
            f"{library:.4f} ms ({lib[name]}) | {100 * bound / ms:.1f}% of "
            f"bound")
    for (name, label), (t1, t2) in halves.items():
        log(f"[kernels] {name} GEMM halves at {label}: GEMM 1 (x @ w1, s1, "
            f"b1, activation, h as bf16 hi + lo) {t1:.4f} ms | GEMM 2 "
            f"(h_hi @ w2 + h_lo @ w2, s2, b2) {t2:.4f} ms")
    rows = []
    for name, label, line in (("grouped_ffn", "bench bucket", 110),
                              ("grouped_ffn_q", "int8 bench bucket", 184)):
        (ms, plain, library), (bound, by), _ = timed[(name, label)]
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/csrc/grouped_gemm.cu",
                     "replaces": "paddle_tpu/ops/pallas_kernels/"
                                 f"grouped_gemm.py:{line}",
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": library})
    return rows


# -- phase 10: the MoE block trained at the bench shape -------------------------

MOE_RUN = dict(batch=4, seq=2048, steps=5, lr=1e-4)


class MoETrain(torch.nn.Module):
    """``sum(out.f32^2) / T + gate.loss`` over one MoELayer (bench.py's
    loss for its `moe` config)."""

    def __init__(self, device, H=MOE["H"], F=MOE["F"], E=MOE["E"],
                 k=MOE["k"], cf=MOE["cf"], seed=0, moe_impl=None):
        super().__init__()
        from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer

        self.moe = MoELayer(d_model=H, d_hidden=F, num_experts=E,
                            gate="gshard", top_k=k, capacity_factor=cf,
                            moe_impl=moe_impl, device=device, seed=seed)

    def forward(self, x):
        out = self.moe(x.to(self.moe.gate.wg.dtype))
        T = x.shape[0] * x.shape[1]
        return out.float().square().sum() / T + self.moe.gate.loss.float()


def _moe_counters():
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg

    return {"grouped_ffn": gg.grouped_ffn, "grouped_ffn_q": gg.grouped_ffn_q}


def _moe_steps(label, run_step, n, per_step):
    """Run 1 + ``n`` steps; each must launch exactly ``per_step``.
    Returns (losses, timed step ms)."""
    counters = _moe_counters()
    losses, step_ms = [], []
    for i in range(n + 1):
        before = {k: f.launches for k, f in counters.items()}
        t1 = time.perf_counter()
        loss = run_step()
        ms = (time.perf_counter() - t1) * 1e3
        losses.append(loss)
        if i:
            step_ms.append(ms)
        got = {k: f.launches - before[k] for k, f in counters.items()}
        log(f"[{label}] step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{loss:.6f}, {ms:.1f} ms, launches {got}")
        if got != per_step:
            raise AssertionError(f"[{label}] step {i} launched {got}, "
                                 f"expected {per_step}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[{label}] losses {losses}: not all finite")
    return losses, step_ms


def phase_moe_train(device, limit, run=None, H=MOE["H"], F=MOE["F"]):
    """bench.py's MoE body (ep_moe_local forward and backward) and then
    MoELayer trained with CompiledTrainStep, both at the bench shape.
    Returns ({kernel: launches over both}, step, batch)."""
    from paddle_tpu_torch.distributed.utils import moe_utils
    from paddle_tpu_torch.models import CompiledTrainStep

    run = dict(MOE_RUN, **(run or {}))
    B, S, n = run["batch"], run["seq"], run["steps"]
    E, k = MOE["E"], MOE["k"]
    T = B * S
    C = moe_capacity(T)
    on_card = device.type == "cuda"
    counters = _moe_counters()
    for f in counters.values():
        f.launches = 0
    per_step = {"grouped_ffn": 1 if on_card else 0, "grouped_ffn_q": 0}

    # (a) the bench body: bf16 tokens and experts, fp32 gate, GShard aux
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    tokens = torch.randn(T, H, generator=gen, device=device).bfloat16()
    wg = torch.randn(H, E, generator=gen, device=device) * 0.02
    w1 = (torch.randn(E, H, F, generator=gen, device=device) * 0.02
          ).bfloat16()
    w2 = (torch.randn(E, F, H, generator=gen, device=device) * 0.02
          ).bfloat16()
    b1 = torch.zeros(E, 1, F, dtype=torch.bfloat16, device=device)
    b2 = torch.zeros(E, 1, H, dtype=torch.bfloat16, device=device)
    leaves = [t.requires_grad_(True) for t in (tokens, w1, b1, w2, b2)]

    def body_step():
        for t in leaves:
            t.grad = None
        out, aux = moe_utils.ep_moe_local(
            tokens, wg, w1, b1, w2, b2, axis_name=None, n=1, num_experts=E,
            top_k=k, capacity=C, activation="gelu", gate_kind="gshard",
            impl="fused" if on_card else None)
        loss = out.float().square().sum() / T + aux
        loss.backward()
        return float(loss.detach())

    losses, step_ms = _moe_steps("moe-body", body_step, n, per_step)
    body_ms = float(np.mean(step_ms))
    log(f"[moe-body] ep_moe_local fwd+bwd, T={T} H={H} E={E} top-{k} F={F} "
        f"C={C}, bf16 tokens and experts, fp32 gate: step {body_ms:.1f} ms "
        f"(mean of {n}; {', '.join(f'{m:.1f}' for m in step_ms)}) | "
        f"{T / (body_ms / 1e3):.1f} MoE tokens/s | losses {losses} | "
        f"{limit}")
    del tokens, wg, w1, w2, b1, b2, leaves
    if on_card:
        torch.cuda.empty_cache()

    # (b) MoELayer through CompiledTrainStep
    t0 = time.perf_counter()
    model = MoETrain(device, H=H, F=F)
    step = CompiledTrainStep(model, lr=run["lr"], compute_dtype="bfloat16",
                             device=device)
    x = torch.as_tensor(np.random.RandomState(0).randn(B, S, H)
                        .astype(np.float32), device=device).bfloat16()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log(f"[moe-train] MoELayer(d_model={H}, d_hidden={F}, num_experts={E}, "
        f"gate='gshard', top_k={k}, capacity_factor={MOE['cf']}) on "
        f"[{B}, {S}, {H}] bf16, C={C}, bf16 compute, fp32 master and "
        f"moments, lr {run['lr']}, remat off, built in "
        f"{time.perf_counter() - t0:.1f} s")
    losses, step_ms = _moe_steps("moe-train", lambda: float(step.step(x)),
                                 n, per_step)
    mean_ms = float(np.mean(step_ms))
    flops = 3 * 4 * E * C * H * F
    peak = (torch.cuda.max_memory_allocated() / 2**30 if on_card
            else float("nan"))
    log(f"[moe-train] step {mean_ms:.1f} ms (mean of {n}; "
        f"{', '.join(f'{m:.1f}' for m in step_ms)}) | "
        f"{T / (mean_ms / 1e3):.1f} tokens/s | GEMM share of "
        f"{BF16_FLOPS / 1e12:g} TFLOP/s {flops / (mean_ms / 1e3) / BF16_FLOPS:.4f}"
        f" (3 x 4·E·C·H·F = {flops:.4e} flops per step) | peak memory "
        f"{peak:.2f} GiB | losses {losses} | {limit}")
    launches = {name: f.launches for name, f in counters.items()}
    return launches, step, (x,)


def phase_moe_profile(step, batch):
    """One traced MoELayer step: device ms of kernel 10, cuBLAS GEMMs,
    sort/gather/scatter, elementwise, AdamW (a record_function range), the
    rest, and the idle share."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile, record_function

    counters = _moe_counters()
    saved = {k: f.launches for k, f in counters.items()}
    update = step._update

    def ranged(*a, **kw):
        with record_function("smoke::adamw"):
            return update(*a, **kw)

    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        step._update = ranged
        stack.callback(delattr, step, "_update")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step.step(*batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    for k, f in counters.items():        # the traced step does not count
        f.launches = saved[k]
    kinds = {"grouped_ffn": 0.0, "gemm": 0.0, "sort/gather/scatter": 0.0,
             "elementwise": 0.0, "other": 0.0}
    adamw = 0.0
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.key == "smoke::adamw":
            if ev.device_type == torch.autograd.DeviceType.CPU:
                adamw += ev.device_time_total / 1e3
            continue
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        name = ev.key.lower()
        kind = ("grouped_ffn" if "gffn" in name else
                "gemm" if any(s in name for s in ("gemm", "cutlass", "xmma",
                                                  "nvjet", "sm90_")) else
                "sort/gather/scatter" if any(s in name for s in (
                    "sort", "radix", "scan", "index", "scatter", "gather",
                    "cub::")) else
                "elementwise" if any(s in name for s in (
                    "elementwise", "vectorized", "unrolled")) else "other")
        kinds[kind] += ms
        per_kernel[ev.key[:60]] = (ms, ev.count)
    busy = sum(kinds.values())
    log(f"[profile-moe] one MoELayer step traced: {wall:.1f} ms wall | "
        f"device busy {busy:.1f} ms "
        f"({', '.join(f'{k} {v:.1f}' for k, v in kinds.items())}; AdamW "
        f"range {adamw:.1f}, inside the elementwise) | idle share "
        f"{1 - busy / wall:.3f}")
    for name, (ms, calls) in sorted(per_kernel.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile-moe]   {ms:9.2f} ms  {calls:5d} launches  {name}")


# -- phase 10c: the int8 MoE forward -------------------------------------------

def phase_moe_int8(device, limit, iters=5, H=MOE["H"], F=MOE["F"]):
    """ep_moe_local with quantize_linear(w1) / quantize_linear(w2) on the
    fused route at T = 8192 and T = 64: exactly one kernel-11 launch per
    forward, and the output within a relative RMS of 0.05 of the bf16
    forward (the serving gate).  Returns kernel-11 launches."""
    from paddle_tpu_torch.distributed.utils import moe_utils
    from paddle_tpu_torch.ops import quant as tq

    E, k = MOE["E"], MOE["k"]
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    wg = torch.randn(H, E, generator=gen, device=device) * 0.02
    w1 = (torch.randn(E, H, F, generator=gen, device=device) * 0.02
          ).bfloat16()
    w2 = (torch.randn(E, F, H, generator=gen, device=device) * 0.02
          ).bfloat16()
    b1 = torch.zeros(E, 1, F, dtype=torch.bfloat16, device=device)
    b2 = torch.zeros(E, 1, H, dtype=torch.bfloat16, device=device)
    q1, q2 = tq.quantize_linear(w1), tq.quantize_linear(w2)
    counters = _moe_counters()
    launches = 0
    for T in (MOE["T"], 64):
        C = moe_capacity(T)
        tokens = torch.randn(T, H, generator=gen, device=device).bfloat16()
        kw = dict(axis_name=None, n=1, num_experts=E, top_k=k, capacity=C,
                  activation="gelu", gate_kind="gshard", impl="fused")
        with torch.no_grad():
            dense, _ = moe_utils.ep_moe_local(tokens, wg, w1, b1, w2, b2,
                                              **kw)
            before = counters["grouped_ffn_q"].launches
            times = []
            for i in range(iters + 1):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out, _ = moe_utils.ep_moe_local(tokens, wg, q1, b1, q2, b2,
                                                **kw)
                e1.record()
                e1.synchronize()
                if i:
                    times.append(e0.elapsed_time(e1))
            got = counters["grouped_ffn_q"].launches - before
        launches += got
        drift = ((out.float() - dense.float()).square().mean().sqrt()
                 / dense.float().square().mean().sqrt()).item()
        ms = float(np.mean(times))
        log(f"[moe-int8] T={T} C={C}: {ms:.4f} ms per int8 forward (mean of "
            f"{iters}; {', '.join(f'{t:.3f}' for t in times)}) | "
            f"{T / (ms / 1e3):.1f} tokens/s | kernel-11 launches {got} over "
            f"{iters + 1} forwards | int8 vs bf16 relative RMS {drift:.5f} "
            f"(limit 0.05) | {limit}")
        if got != iters + 1:
            raise AssertionError(f"[moe-int8] {got} kernel-11 launches for "
                                 f"{iters + 1} forwards")
        if not (np.isfinite(drift) and drift < 0.05):
            raise AssertionError(f"[moe-int8] drift {drift} over 0.05")
        del tokens, dense, out
    return launches


# -- phase 11: card vs CPU MoE training ----------------------------------------

def phase_moe_parity(device, steps=3):
    """The same MoELayer weights trained on the card (kernel 10) and on
    the CPU (its plain version), fp32, H=256, F=512, E=8, top-2, T=512."""
    import os

    from paddle_tpu_torch.models import CompiledTrainStep

    counters = _moe_counters()
    x = np.random.RandomState(2).randn(2, 256, 256).astype(np.float32)
    old = os.environ.get("PT_GROUPED_GEMM")
    os.environ["PT_GROUPED_GEMM"] = "pallas"
    losses = {}
    try:
        for dev in (device, torch.device("cpu")):
            model = MoETrain("cpu", H=256, F=512, seed=3, moe_impl="fused")
            step = CompiledTrainStep(model, lr=1e-3, device=dev)
            before = counters["grouped_ffn"].launches
            losses[dev.type] = [float(step.step(x)) for _ in range(steps)]
            launched = counters["grouped_ffn"].launches - before
            log(f"[moe-parity] {dev.type}: losses {losses[dev.type]}, "
                f"kernel-10 launches {launched}")
            if dev.type == "cuda" and launched != steps:
                raise AssertionError("[moe-parity] the card run did not take "
                                     f"kernel 10 once per step: {launched}")
    finally:
        if old is None:
            del os.environ["PT_GROUPED_GEMM"]
        else:
            os.environ["PT_GROUPED_GEMM"] = old
    got, want = np.array(losses[device.type]), np.array(losses["cpu"])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    log(f"[moe-parity] {steps} fp32 steps, H=256, F=512, E=8, top-2, T=512: "
        f"max relative loss difference card vs CPU {rel:.3e} (limit 1e-4: "
        f"fp32 on both, TF32 off, scatter-add atomics and other summation "
        f"orders)")
    if not rel <= 1e-4:
        raise AssertionError(f"[moe-parity] losses differ: {losses}")


# -- phases 12-14: the vision path -----------------------------------------------

RESNET_RUN = dict(batch=256, image=224, steps=5, k=5, lr=0.1)
#: bench.py's estimate: ~4.1 GFLOP a 224 x 224 image forward, train ~ 3x
RESNET_FWD_FLOPS = 4.1e9
DET_RUN = dict(batch=64, image=320, steps=10, k=5, lr=1e-3)
LAYOUTS = {"NCHW": torch.contiguous_format,
           "channels_last": torch.channels_last}


class Detector(torch.nn.Module):
    """bench.py's ``_bench_detection`` model (bench.py:484-499) on the
    port: ResNet-18 features (``num_classes=0, with_pool=False``), 1x1
    box (512 -> 4) and class (512 -> 80) heads, loss ``mean|box(f) -
    box_t| + BCE-with-logits(cls(f), cls_t)``."""

    def __init__(self, device, num_classes=80, seed=0):
        from paddle_tpu_torch import nn as pnn
        from paddle_tpu_torch.nn.initializer import seeded_generator
        from paddle_tpu_torch.vision.models import resnet18

        super().__init__()
        self.backbone = resnet18(num_classes=0, with_pool=False,
                                 device=device, seed=seed)
        gen = seeded_generator(device, seed + 1)
        self.box = pnn.Conv2D(512, 4, 1, device=device, generator=gen)
        self.cls = pnn.Conv2D(512, num_classes, 1, device=device,
                              generator=gen)
        self.to(memory_format=torch.channels_last)   # as the backbone

    def heads(self, x):
        """(box offsets ``[B, 4, H/32, W/32]``, class logits ``[B, 80,
        H/32, W/32]``)."""
        f = self.backbone(x)
        return self.box(f), self.cls(f)

    def forward(self, x, box_t, cls_t):
        from paddle_tpu_torch.nn import functional as F

        box, cls = self.heads(x)
        l_box = torch.abs(box - box_t).mean()
        l_cls = F.binary_cross_entropy_with_logits(cls, cls_t)
        return l_box + l_cls


def _bn_stats(model):
    return {k: v.detach().clone() for k, v in model.named_buffers()}


def _stats_unchanged(model, before):
    return [k for k, v in model.named_buffers() if not torch.equal(v,
                                                                   before[k])]


def _peak_gib(device):
    return (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else float("nan"))


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _vision_steps(tag, step, batch, device, run, per_image_flops=None,
                  unit="imgs"):
    """Two warm-up steps (the first timed: cuDNN's first calls), ``steps``
    timed eager steps, then ``multi_step(k)`` twice (capture, then replay
    only); one traced eager step and a traced replay for the idle shares.
    The model's running statistics must be where they were after all of
    it, and every loss finite.  Returns a dict of the numbers."""
    model = step.model
    before = _bn_stats(model)
    B, k = batch[0].shape[0], run["k"]
    loss, first_ms = _timed(device, lambda: float(step.step(*batch)))
    losses = [loss, float(step.step(*batch))]
    _reset_peak(device)
    eager_ms = []
    for _ in range(run["steps"]):
        loss, ms = _timed(device, lambda: float(step.step(*batch)))
        losses.append(loss)
        eager_ms.append(ms)
    eager_peak = _peak_gib(device)
    _, cap_ms = _timed(device, lambda: step.multi_step(k, *batch))
    losses += step.last_losses.tolist()
    _, graph_ms = _timed(device, lambda: step.multi_step(k, *batch))
    losses += step.last_losses.tolist()
    graph_peak = _peak_gib(device)
    ew, eb = _traced(lambda: step.step(*batch))
    gw, gb = _traced(lambda: step.multi_step(k, *batch))
    moved = _stats_unchanged(model, before)
    eager = float(np.median(eager_ms))
    graph = graph_ms / k
    out = {"first_ms": first_ms, "eager_ms": eager, "graph_ms": graph,
           "capture_ms": cap_ms, "eager_peak": eager_peak,
           "graph_peak": graph_peak, "eager_idle": 1 - eb / ew,
           "graph_idle": 1 - gb / gw, "losses": losses}
    for how, ms in (("eager step()", eager), (f"multi_step({k}) replayed",
                                              graph)):
        ips = B / (ms / 1e3)
        mfu = ("" if per_image_flops is None else
               f" | MFU {ips * 3 * per_image_flops / BF16_FLOPS:.4f} (imgs/s"
               f" x 3 x {per_image_flops:.2e} / {BF16_FLOPS / 1e12:g} "
               f"TFLOP/s bf16)")
        log(f"[{tag}] {how}: {ms:.1f} ms a step | {ips:.1f} {unit}/s{mfu}")
    log(f"[{tag}] first step (cuDNN's first calls) {first_ms:.1f} ms; eager "
        f"steps {', '.join(f'{m:.1f}' for m in eager_ms)} ms (median "
        f"{eager:.1f}); multi_step({k}) first call (warm-up, capture, "
        f"replay) {cap_ms:.1f} ms | peak memory eager {eager_peak:.2f} GiB, "
        f"with the graph {graph_peak:.2f} GiB | traced: eager wall "
        f"{ew:.1f} ms a step, busy {eb:.1f}, idle share "
        f"{1 - eb / ew:.3f}; replay wall {gw / k:.1f} ms a step, busy "
        f"{gb / k:.1f}, idle share {1 - gb / gw:.3f} | losses "
        f"{[round(x, 4) for x in losses]}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[{tag}] losses not finite: {losses}")
    if moved:
        raise AssertionError(f"[{tag}] the step moved running statistics: "
                             f"{moved[:4]}")
    return out


def phase_resnet_train(device, limit, run=None, layouts=tuple(LAYOUTS),
                       classes=1000):
    """12: bench.py's config 1 (bench.py:621-681): resnet50(num_classes=
    1000) in training mode, random weights from seed 0, B seeded bf16
    images at 224 px and int labels, CompiledTrainStep(lr=0.1,
    compute_dtype="bfloat16", loss_fn=cross_entropy) with its defaults
    (AdamW, fp32 master, wd 0.01, clip 1.0); in each memory layout
    (the conv weights NCHW-contiguous or channels-last).  Returns
    {layout: numbers}."""
    from paddle_tpu_torch.testing.vision_profile import resnet50_step

    run = dict(RESNET_RUN, **(run or {}))
    res = {}
    for name in layouts:
        t0 = time.perf_counter()
        step, batch = resnet50_step(device, run["batch"], LAYOUTS[name],
                                    image=run["image"], classes=classes,
                                    lr=run["lr"])
        nparams = sum(p.numel() for p in step.params.values())
        log(f"[resnet-train {name}] resnet50: {nparams / 1e6:.3f} M "
            f"parameters, B={run['batch']}, {run['image']} px bf16, bf16 "
            f"compute, fp32 master, AdamW lr {run['lr']}; built in "
            f"{time.perf_counter() - t0:.1f} s | {limit}")
        res[name] = _vision_steps(f"resnet-train {name}", step, batch,
                                  device, run,
                                  per_image_flops=RESNET_FWD_FLOPS)
        del step, batch
        _empty(device)
    if len(res) > 1:
        ms = {n: r["eager_ms"] for n, r in res.items()}
        log(f"[resnet-train] eager ms a step by layout {ms}, replayed "
            f"{ {n: round(r['graph_ms'], 2) for n, r in res.items()} }: "
            f"faster eager {min(ms, key=ms.get)}")
    return res


def phase_resnet_graph(device, limit, run=None, k=3, lr=1e-5):
    """12c: three ResNet-50 steps from one seed at phase 12's shape: a
    and b eager (is an eager step repeatable?), c as one replayed
    multi_step(3).  Bit for bit where cuDNN gives the same bits; where it
    does not, the losses and every parameter are held at bf16's
    tolerance (relative 2e-2).  lr 1e-5 keeps the steps out of the
    chaotic region where rounding noise is amplified (see
    tests/test_torch_resnet.py)."""
    from paddle_tpu_torch.testing.vision_profile import resnet50_step

    run = dict(RESNET_RUN, **(run or {}))

    def build():
        return resnet50_step(device, run["batch"], image=run["image"],
                             lr=lr)

    (a, batch), (b, _), (c, _) = build(), build(), build()
    la = [float(a.step(*batch)) for _ in range(k)]
    lb = [float(b.step(*batch)) for _ in range(k)]
    c.multi_step(k, *batch)
    lc = c.last_losses.tolist()
    ab, ac = _state_equal(a, b), _state_equal(a, c)
    n = sum(len(getattr(a, t)) for t in ("params", "_master", "_m", "_v"))
    log(f"[resnet-graph] {k} steps from one seed, B={run['batch']}, lr {lr}:"
        f" eager a {la} | eager b {lb} | multi_step c {lc} | state tensors "
        f"that differ: a vs b {len(ab)} of {n}{' ' + str(ab[:3]) if ab else ''}"
        f", a vs c {len(ac)}{' ' + str(ac[:3]) if ac else ''}")

    def worst(x, y):
        return max(float((x.params[p].float() - y.params[p].float()).norm()
                         / y.params[p].float().norm()) for p in y.params)

    exact = la == lb == lc and not ab and not ac
    if exact:
        log("[resnet-graph] eager steps are repeatable and the replay "
            "equals them bit for bit")
    else:
        rel = max(abs(x / y - 1) for x, y in zip(lb + lc, la + la))
        w = max(worst(b, a), worst(c, a))
        log(f"[resnet-graph] not bit for bit: largest relative loss "
            f"difference {rel:.3e}, worst parameter relative difference "
            f"{w:.3e} (limit 2e-2, bf16) | {limit}")
        if not (rel <= 2e-2 and w <= 2e-2):
            raise AssertionError("[resnet-graph] replays or eager steps "
                                 "drifted")
    del a, b, c, batch
    _empty(device)
    return exact


def phase_detection_train(device, limit, run=None):
    """13: bench.py's config 4 (bench.py:469-519): the detector at B = 64,
    320 px bf16 images, fp32 box targets [B, 4, 10, 10] and class targets
    [B, 80, 10, 10] (> 0.95 of U(0, 1)), CompiledTrainStep(lr=1e-3,
    compute_dtype="bfloat16")."""
    from paddle_tpu_torch.models import CompiledTrainStep

    run = dict(DET_RUN, **(run or {}))
    B, hw = run["batch"], run["image"]
    t0 = time.perf_counter()
    model = Detector(device)
    model.train()
    step = CompiledTrainStep(model, lr=run["lr"], compute_dtype="bfloat16",
                             device=device)
    rng = np.random.RandomState(0)
    side = hw // 32
    imgs = torch.as_tensor(rng.randn(B, 3, hw, hw).astype(np.float32),
                           device=device).to(torch.bfloat16)
    box_t = torch.as_tensor(rng.randn(B, 4, side, side).astype(np.float32),
                            device=device)
    cls_t = torch.as_tensor((rng.rand(B, 80, side, side) > 0.95).astype(
        np.float32), device=device)
    log(f"[det-train] ResNet-18 backbone + 1x1 box / class heads, B={B}, "
        f"{hw} px bf16, bf16 compute, lr {run['lr']}: "
        f"{sum(p.numel() for p in step.params.values()) / 1e6:.3f} M "
        f"parameters, built in {time.perf_counter() - t0:.1f} s | {limit}")
    res = _vision_steps("det-train", step, (imgs, box_t, cls_t), device,
                        run)
    del step, model
    _empty(device)
    return res


def _max_rel(got, want):
    return float((got.detach().cpu().double() - want.detach().double())
                 .abs().max() / want.detach().double().abs().max())


def phase_vision_parity(device, steps=3, lr=1e-5):
    """14: fp32, the card against the CPU, with TF32 at the library's
    defaults (cuDNN's on, matmul's off) rather than the script's switch:
    resnet18 (10 classes) at 32 x 32, B = 4, and one ResNet(
    BottleneckBlock, 50) forward.  Eval logits within 1e-5 of the largest
    (running statistics drawn away from 0 and 1), 3 train-step losses
    within 1e-4 relative, the running statistics after one eager
    train-mode forward within 1e-5 of each buffer's largest value, as
    the logits (fp32 activations of a few units to tens that differ by
    about 1e-6 relative through 17 layers give batch statistics that
    differ by some 1e-5 absolute; the CPU's own fp32 statistics against
    fp64 are printed beside them as the yardstick).  The library's own conv2d under its
    TF32 default is shown beside the port's."""
    from paddle_tpu_torch.models import CompiledTrainStep, load_numpy_state
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision.models import BottleneckBlock, ResNet
    from paddle_tpu_torch.vision.models import resnet18

    cpu = torch.device("cpu")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(3)
    x = torch.as_tensor(rng.randn(4, 3, 32, 32).astype(np.float32))
    y = torch.as_tensor(rng.randint(0, 10, (4,)))
    try:
        def pair(ctor, **kw):
            ref = ctor(device=cpu, seed=0, **kw)
            state = {k: v.detach().numpy() for k, v in
                     ref.state_dict().items()}
            for key in state:
                if key.endswith("_mean"):
                    state[key] = 0.1 * rng.randn(*state[key].shape).astype(
                        np.float32)
                elif key.endswith("_variance"):
                    state[key] = rng.uniform(0.5, 2, state[key].shape
                                             ).astype(np.float32)
            card = ctor(device=device, seed=1, **kw)
            load_numpy_state(ref, state)
            load_numpy_state(card, state)
            return ref, card

        errs = {}
        for tag, ctor, kw in (
                ("resnet18", resnet18, dict(num_classes=10)),
                ("ResNet(BottleneckBlock, 50)",
                 lambda **a: ResNet(BottleneckBlock, 50, **a),
                 dict(num_classes=10))):
            ref, card = pair(ctor, **kw)
            ref.eval()
            card.eval()
            with torch.no_grad():
                errs[f"{tag} eval logits"] = _max_rel(card(x.to(device)),
                                                      ref(x))
            if tag == "resnet18":
                # the yardstick: the CPU's fp32 statistics against fp64
                ref64 = ctor(device=cpu, seed=0, **kw).double()
                ref64.load_state_dict(ref.state_dict())
                for m in (ref, card, ref64):
                    m.train()
                with torch.no_grad():
                    ref(x)
                    card(x.to(device))
                    ref64(x.double())
                errs["resnet18 running statistics, CPU fp32 vs fp64"] = max(
                    _max_rel(a, b) for a, b in zip(ref.buffers(),
                                                   ref64.buffers()))
                errs["resnet18 running statistics"] = max(
                    _max_rel(a, b) for a, b in zip(card.buffers(),
                                                   ref.buffers()))
                errs["resnet18 running statistics, largest |difference|"] \
                    = max(float((a.cpu() - b).abs().max()) for a, b in
                          zip(card.buffers(), ref.buffers()))
                errs["resnet18 running statistics, largest value"] = max(
                    float(b.abs().max()) for b in ref.buffers())
        losses = {}
        for dev in (device, cpu):
            model = resnet18(num_classes=10, device=cpu, seed=0)
            model.train()
            step = CompiledTrainStep(model, lr=lr, loss_fn=F.cross_entropy,
                                     device=dev)
            losses[dev.type] = [float(step.step(x, y)) for _ in range(steps)]
        got, want = np.array(losses[device.type]), np.array(losses["cpu"])
        errs["resnet18 train losses"] = float(np.max(np.abs(got - want)
                                                     / np.abs(want)))
        # the library's conv2d at its TF32 default, beside the port's
        w = torch.as_tensor(rng.randn(64, 64, 3, 3).astype(np.float32)) * 0.05
        a = torch.as_tensor(rng.randn(8, 64, 56, 56).astype(np.float32))
        want = torch.nn.functional.conv2d(a, w, padding=1)
        lib = torch.nn.functional.conv2d(a.to(device), w.to(device),
                                         padding=1)
        ours = F.conv2d(a.to(device), w.to(device), padding=1)
        errs["conv 64->64 3x3: library at its TF32 default"] = _max_rel(
            lib, want)
        errs["conv 64->64 3x3: port"] = _max_rel(ours, want)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved
    limits = {"resnet18 eval logits": 1e-5,
              "ResNet(BottleneckBlock, 50) eval logits": 1e-5,
              "resnet18 running statistics": 1e-5,
              "resnet18 train losses": 1e-4,
              "conv 64->64 3x3: port": 1e-5}
    log(f"[vision-parity] fp32 card vs CPU, TF32 at the library defaults "
        f"(cuDNN on, matmul off), lr {lr}: " + "; ".join(
            f"{k} {v:.3e}" + (f" (limit {limits[k]:g})" if k in limits
                              else "") for k, v in errs.items())
        + f" | losses card {losses[device.type]}, cpu {losses['cpu']}")
    bad = {k: v for k, v in errs.items() if k in limits
           and not v <= limits[k]}
    if bad:
        raise AssertionError(f"[vision-parity] beyond the limits: {bad}")
    return errs


# -- phases 15-16: the diffusion UNet ----------------------------------------------

UNET_RUN = dict(batch=4, latent=32, steps=3, k=2)
UNET_64_RUN = dict(batch=4, latent=64, steps=2, k=2)


def unet_flops(unet_kw, batch, latent, context=77):
    """The forward flops of ``UNet2DConditionModel(**unet_kw)`` at
    ``[batch, 4, latent, latent]`` latents and ``context`` text tokens,
    from its shapes: the model built on the meta device (no memory, no
    compute) runs forward with hooks that count 2 flops a multiply-add
    in every conv (output elements x in / groups x kh x kw), every Linear
    (output elements x in) and the two attention products (2 x 2·B·N·M·C).
    Returns {part: flops}."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.models import UNet2DConditionModel
    from paddle_tpu_torch.models.unet import CrossAttention

    meta = UNet2DConditionModel(device="meta", **(unet_kw or {}))
    ctx_dim = meta.mid_attn.attn2.to_k.weight.shape[0]
    got = {"conv": 0, "linear": 0, "attention": 0}

    def conv(mod, args, out):
        k = mod.weight.shape
        got["conv"] += 2 * out.numel() * k[1] * k[2] * k[3]

    def linear(mod, args, out):
        got["linear"] += 2 * out.numel() * mod.weight.shape[0]

    def attention(mod, args, out):
        x = args[0]
        ctx = args[1] if len(args) > 1 and args[1] is not None else x
        got["attention"] += 4 * x.shape[0] * x.shape[1] * ctx.shape[1] \
            * x.shape[2]

    for mod in meta.modules():
        hook = (conv if isinstance(mod, pnn.Conv2D) else
                linear if isinstance(mod, pnn.Linear) else
                attention if isinstance(mod, CrossAttention) else None)
        if hook is not None:
            mod.register_forward_hook(hook)
    m = torch.device("meta")
    with torch.no_grad():
        meta(torch.empty(batch, meta.conv_in.weight.shape[1], latent,
                         latent, device=m),
             torch.empty(batch, dtype=torch.int32, device=m),
             torch.empty(batch, context, ctx_dim, device=m))
    return got


def _unet_train_counters():
    return {**_train_counters(), **_moe_counters(), **_serve_counters()}


def phase_unet_train(device, limit, run=None, tag="unet-train",
                     unet_kw=None):
    """15 (and 15c at ``run=UNET_64_RUN``): bench.py's config 5 step,
    timed as the vision phases are (``_vision_steps``), with every
    kernel wrapper's count set to 0 before and read after: the UNet's
    step launches none of them.  Returns (numbers, step, batch)."""
    from paddle_tpu_torch.testing.vision_profile import unet_step
    from paddle_tpu_torch.models import UNet2DConditionModel

    run = dict(UNET_RUN, **(run or {}))
    B, lat = run["batch"], run["latent"]
    t0 = time.perf_counter()
    unet = UNet2DConditionModel(device=device, seed=0, **(unet_kw or {}))
    step, batch = unet_step(device, B, lat, unet=unet)
    flops = unet_flops(unet_kw, B, lat)
    step_flops = 3 * sum(flops.values())
    log(f"[{tag}] UNet2DConditionModel: {unet.num_params()} parameters "
        f"({unet.num_params() / 1e6:.1f} M), B={B}, latents [{B}, 4, {lat}, "
        f"{lat}] fp32, context {list(batch[2].shape)} fp32, bf16 weights "
        f"(norms fp32), fp32 master, "
        f"bf16 moments, AdamW lr 1e-4; built in {time.perf_counter() - t0:.1f}"
        f" s | forward flops a step (meta-device count): "
        + ", ".join(f"{k} {v / 1e9:.2f} G" for k, v in flops.items())
        + f"; train step 3 x {sum(flops.values()) / 1e12:.4f} = "
        f"{step_flops / 1e12:.4f} TFLOP ({sum(flops.values()) / B / 1e9:.1f}"
        f" GFLOP a sample forward) | {limit}")
    counters = _unet_train_counters()
    _zero_counts(counters)
    res = _vision_steps(tag, step, batch, device, run, unit="samples")
    launched = {k: n for k, n in _counts(counters).items() if n}
    for how in ("eager", "graph"):
        ms = res[f"{how}_ms"]
        tf = step_flops / (ms / 1e3) / 1e12
        log(f"[{tag}] {how}: {ms:.2f} ms a step | {B / (ms / 1e3):.2f} "
            f"samples/s | {tf:.2f} TFLOP/s achieved, {tf * 1e12 / FP32_FLOPS:.4f} "
            f"of the fp32 peak ({FP32_FLOPS / 1e12:g}), "
            f"{tf * 1e12 / BF16_FLOPS:.4f} of the bf16 peak "
            f"({BF16_FLOPS / 1e12:g} TFLOP/s) | peak memory "
            f"{res[f'{how}_peak']:.2f} GiB | idle share "
            f"{res[f'{how}_idle']:.3f}")
    if launched:
        raise AssertionError(f"[{tag}] the UNet step launched kernels of "
                             f"the line: {launched}")
    log(f"[{tag}] none of the eleven kernels launched")
    res["flops"] = step_flops
    return res, step, batch


def phase_unet_profile(step, batch, device, limit, iters=20):
    """15b: the port's group_norm against the library's at the top
    level's shape [B, 320, 32, 32] fp32, 32 groups: equal bits or the
    largest difference, and both timed (``time_ms``: CUDA events, L2
    flushed; forward; forward + backward).  (Its traced step by family
    was cut for time: ``python3 -m paddle_tpu_torch.testing.vision_profile
    unet`` prints it.)"""
    from paddle_tpu_torch.ops import nn_ops

    B = batch[0].shape[0]
    gen = torch.Generator(device).manual_seed(7)
    x = torch.randn(B, 320, 32, 32, device=device, generator=gen)
    w = 1 + 0.1 * torch.randn(320, device=device, generator=gen)
    b = 0.1 * torch.randn(320, device=device, generator=gen)
    g = torch.randn(x.shape, device=device, generator=gen)
    ours = nn_ops.group_norm(x, w, b, 1e-5, 32)
    lib = torch.nn.functional.group_norm(x, 32, w, b, 1e-5)
    same = torch.equal(ours, lib)
    diff = float((ours - lib).abs().max())

    def fwd_bwd(fn):
        def run():
            xr = x.detach().requires_grad_(True)
            torch.autograd.grad(fn(xr), xr, g)
        return run

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=device)
    times = {}
    for name, fn in (("port", lambda a=x: nn_ops.group_norm(a, w, b, 1e-5,
                                                            32)),
                     ("library", lambda a=x: torch.nn.functional.group_norm(
                         a, 32, w, b, 1e-5))):
        times[name] = (time_ms(fn, flush, iters),
                       time_ms(fwd_bwd(fn), flush, iters))
    nbytes = x.numel() * 4
    log(f"[unet-profile] group_norm at [{B}, 320, 32, 32] fp32, 32 groups: "
        f"port vs torch.nn.functional.group_norm "
        f"{'bit for bit' if same else f'differ, largest |difference| {diff:.3e}'}"
        f" | ms forward / forward + backward: port {times['port'][0]:.4f} / "
        f"{times['port'][1]:.4f}, library {times['library'][0]:.4f} / "
        f"{times['library'][1]:.4f} | bounds (x read once, y written once; "
        f"backward x, g read, dx written) {2 * nbytes / HBM_BYTES_PER_S * 1e3:.4f}"
        f" / {5 * nbytes / HBM_BYTES_PER_S * 1e3:.4f} | {limit}")


def phase_unet_parity(device, steps=3, lr=1e-4):
    """16: fp32, the card against the CPU, with TF32 at the library's
    defaults (cuDNN's on, matmul's off): a UNet at full depth and narrow
    widths (every block type, both samplers, all the skips), its eval
    output within 1e-5 of the largest, 3 train-step losses within 1e-4
    relative; interpolate nearest at 5 -> 3 and 8 -> 4 bit for bit."""
    from paddle_tpu_torch.models import (
        CompiledTrainStep, UNet2DConditionModel, load_numpy_state,
    )
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.testing.vision_profile import UNetTrain

    cpu = torch.device("cpu")
    kw = dict(block_out_channels=(64, 128, 128, 128), layers_per_block=2,
              cross_attention_dim=64)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(5)
    inputs = [torch.as_tensor(a) for a in (
        rng.randn(2, 4, 16, 16).astype(np.float32),
        rng.randint(0, 1000, (2,)).astype(np.int32),
        rng.randn(2, 7, 64).astype(np.float32),
        rng.randn(2, 4, 16, 16).astype(np.float32))]
    errs = {}
    try:
        ref = UNet2DConditionModel(device=cpu, seed=0, **kw)
        state = {k: v.numpy() for k, v in ref.state_dict().items()}
        card = UNet2DConditionModel(device=device, seed=1, **kw)
        load_numpy_state(card, state)
        ref.eval()
        card.eval()
        with torch.no_grad():
            want = ref(*inputs[:3])
            got = card(*(a.to(device) for a in inputs[:3]))
        errs["eval output"] = _max_rel(got, want)
        losses = {}
        for dev in (device, cpu):
            model = UNet2DConditionModel(device=cpu, seed=2, **kw)
            load_numpy_state(model, state)
            step = CompiledTrainStep(UNetTrain(model), lr=lr, device=dev)
            losses[dev.type] = [float(step.step(*inputs))
                                for _ in range(steps)]
            del step, model
        g, w = np.array(losses[device.type]), np.array(losses["cpu"])
        errs["train losses"] = float(np.max(np.abs(g - w) / np.abs(w)))
        exact = {}
        for src, dst in ((5, 3), (8, 4)):
            x = torch.as_tensor(rng.randn(2, 3, src, src).astype(np.float32))
            exact[f"{src}->{dst}"] = torch.equal(
                F.interpolate(x.to(device), size=(dst, dst)).cpu(),
                F.interpolate(x, size=(dst, dst)))
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved
    limits = {"eval output": 1e-5, "train losses": 1e-4}
    log(f"[unet-parity] fp32 card vs CPU, TF32 at the library defaults "
        f"(cuDNN on, matmul off), UNet {kw}, 16 x 16 latents, B = 2, lr "
        f"{lr}: " + "; ".join(f"{k} {v:.3e} (limit {limits[k]:g})"
                              for k, v in errs.items())
        + f" | interpolate nearest card = CPU bit for bit: {exact} | losses "
        f"card {losses[device.type]}, cpu {losses['cpu']}")
    bad = {k: v for k, v in errs.items() if not v <= limits[k]}
    if bad or not all(exact.values()):
        raise AssertionError(f"[unet-parity] beyond the limits: {bad} "
                             f"{exact}")
    return errs


# -- phases 17-17d: the eager training loop --------------------------------------

EAGER_RUN = dict(batch=256, image=224, images=768, workers=4, steps=5,
                 classes=1000)
EAGER_DET_RUN = dict(batch=64, image=320, steps=5)


class EagerLoop:
    """One step of the eager loop a Paddle user writes: the loss under
    ``auto_cast``, ``scaler.scale(loss).backward()``, then ``_update``
    (``scaler.step``, ``scaler.update``, ``clear_grad``).  ``step`` has
    ``testing.vision_profile.families``' shape, so one traced step splits
    by family (the update lands in its ``adamw`` family)."""

    def __init__(self, model, opt, scaler, loss_fn, level="O1",
                 dtype="bfloat16"):
        self.model, self.opt, self.scaler = model, opt, scaler
        self.loss_fn, self.level, self.dtype = loss_fn, level, dtype

    def step(self, *batch):
        from paddle_tpu_torch import amp

        with amp.auto_cast(enable=self.level != "O0", level=self.level,
                           dtype=self.dtype):
            loss = self.loss_fn(self.model, *batch)
        self.scaler.scale(loss).backward()
        self._update()
        return loss.detach()

    def _update(self):
        self.scaler.step(self.opt)
        self.scaler.update()
        self.opt.clear_grad()

    def _global_norm(self):
        return None


def _ce_loss(model, x, y):
    from paddle_tpu_torch.nn import functional as F

    out = model(x)
    if isinstance(out, tuple):       # GoogLeNet's auxiliary heads
        return F.cross_entropy(out[0], y) + 0.3 * (
            F.cross_entropy(out[1], y) + F.cross_entropy(out[2], y))
    return F.cross_entropy(out, y)


def _det_loss(model, x, box_t, cls_t):
    return model(x, box_t, cls_t)


def _rss_gib():
    with open("/proc/self/status") as f:
        kb = next(int(line.split()[1]) for line in f
                  if line.startswith("VmRSS:"))
    return kb / 2**20


def _launched(counters):
    return {k: n for k, n in _counts(counters).items() if n}


def _no_kernels(tag, counters):
    launched = _launched(counters)
    if launched:
        raise AssertionError(f"[{tag}] launched kernels of the line: "
                             f"{launched}")


def phase_eager_resnet(device, limit, run=None, graph_ms=None):
    """17: BASELINE config 1 as its row says (BASELINE.md:23): the eager
    loop over io.DataLoader, auto_cast O1, GradScaler and Momentum with
    L2 decay (He et al. 2016's recipe) on resnet50.  ``graph_ms``: phase
    12's replayed CompiledTrainStep a step, printed beside."""
    from paddle_tpu_torch import amp, io, optimizer
    from paddle_tpu_torch.testing import vision_profile as vp
    from paddle_tpu_torch.vision.models import resnet50

    run = dict(EAGER_RUN, **(run or {}))
    B, hw, n = run["batch"], run["image"], run["images"]
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((n, 3, hw, hw), dtype=np.float32)
    labels = rng.integers(0, run["classes"], n, dtype=np.int64)
    loader = io.DataLoader(io.TensorDataset([imgs, labels]), batch_size=B,
                           shuffle=True, drop_last=True,
                           num_workers=run["workers"], places=device)
    model = resnet50(num_classes=run["classes"], device=device, seed=0)
    model.train()
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=model.parameters(),
                             weight_decay=optimizer.L2Decay(1e-4))
    scaler = amp.GradScaler()
    loop = EagerLoop(model, opt, scaler, _ce_loss, level="O1")
    log(f"[eager-resnet] resnet50 ({sum(p.numel() for p in model.parameters()) / 1e6:.3f}"
        f" M fp32 parameters), {n} images [3, {hw}, {hw}] fp32 "
        f"({imgs.nbytes / 1e6:.0f} MB on the host) and int64 labels, "
        f"DataLoader(batch_size={B}, num_workers={run['workers']}, "
        f"shuffle=True, drop_last=True), Momentum(0.1, 0.9, L2Decay(1e-4)),"
        f" GradScaler(2**16), auto_cast(O1, bf16); data and model in "
        f"{time.perf_counter() - t0:.1f} s | {limit}")

    def batches():
        while True:
            yield from loader

    np.random.seed(0)
    it = batches()
    counters = _unet_train_counters()
    _zero_counts(counters)
    waits, steps, losses = [], [], []
    for i in range(1 + run["steps"]):
        _sync(device)
        t1 = time.perf_counter()
        x, y = next(it)
        t2 = time.perf_counter()
        loss = loop.step(x, y)
        losses.append(float(loss))
        t3 = time.perf_counter()
        if i == 0:
            first = ((t3 - t1) * 1e3, (t2 - t1) * 1e3)
            _reset_peak(device)
            continue
        waits.append((t2 - t1) * 1e3)
        steps.append((t3 - t1) * 1e3)
    peak = _peak_gib(device)
    if device.type == "cuda":
        fam, wall, busy, kernels, spans = vp.families(loop, (x, y), steps=1)
        fam["momentum + scaler"] = fam.pop("adamw")
    else:
        wall, busy = float("nan"), float("nan")
    _no_kernels("eager-resnet", counters)
    del it
    ms = float(np.median(steps))
    ips = B / (ms / 1e3)
    mfu = ips * 3 * RESNET_FWD_FLOPS / BF16_FLOPS
    log(f"[eager-resnet] host memory of this process {_rss_gib():.1f} GiB "
        f"(each epoch forks its workers from it) | first step (workers' "
        f"fork and first batch, "
        f"cuDNN's first calls) {first[0]:.1f} ms, {first[1]:.1f} waited on "
        f"the loader; steps {', '.join(f'{v:.1f}' for v in steps)} ms "
        f"(median {ms:.1f}), waited on the loader "
        f"{', '.join(f'{v:.1f}' for v in waits)} ms (median "
        f"{float(np.median(waits)):.1f}) | {ips:.1f} imgs/s | MFU "
        f"{mfu:.4f} (imgs/s x 3 x {RESNET_FWD_FLOPS:.2e} / "
        f"{BF16_FLOPS / 1e12:g} TFLOP/s bf16) | peak memory {peak:.2f} GiB "
        f"| scale after the steps {scaler._scale:g} | losses "
        f"{[round(v, 4) for v in losses]}")
    if device.type == "cuda":
        vp.report("eager-resnet", fam, wall, busy, kernels, spans, log=log)
    if graph_ms is not None:
        log(f"[eager-resnet] the eager O1 step {ms:.1f} ms against phase "
            f"12's replayed CompiledTrainStep {graph_ms:.1f} ms (bf16 "
            f"images, bf16 compute, AdamW): {ms / graph_ms:.2f}x")
    log("[eager-resnet] none of the eleven kernels launched")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[eager-resnet] losses not finite: {losses}")
    del loader, model, opt, loop, x, y
    gc.collect()
    _empty(device)
    return {"step_ms": ms, "wait_ms": float(np.median(waits)),
            "idle": 1 - busy / wall, "peak": peak}


def phase_eager_detection(device, limit, run=None):
    """17b: BASELINE config 4 as its row says (BASELINE.md:26): phase 13's
    detector under decorate(O2), AdamW(1e-3), GradScaler(2**10) and
    auto_cast(O2), as tests/test_detection_amp.py:37-60 trains."""
    from paddle_tpu_torch import amp, optimizer

    run = dict(EAGER_DET_RUN, **(run or {}))
    B, hw = run["batch"], run["image"]
    model = Detector(device)
    model.train()
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters())
    model, opt = amp.decorate(models=model, optimizers=opt, level="O2")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)
    bad = [k for m_name, m in model.named_modules()
           for k, p in m.named_parameters(recurse=False)
           if p.dtype != (torch.float32 if "bn" in m_name
                          or "downsample.1" in m_name else torch.bfloat16)]
    if bad or not opt._use_master_weights:
        raise AssertionError(f"[eager-det] decorate's dtypes: {bad[:4]}")
    rng = np.random.RandomState(0)
    side = hw // 32
    x = torch.as_tensor(rng.randn(B, 3, hw, hw).astype(np.float32),
                        device=device)
    box_t = torch.as_tensor(rng.randn(B, 4, side, side).astype(np.float32),
                            device=device)
    cls_t = torch.as_tensor((rng.rand(B, 80, side, side) > 0.95).astype(
        np.float32), device=device)
    loop = EagerLoop(model, opt, scaler, _det_loss, level="O2")
    counters = _unet_train_counters()
    _zero_counts(counters)
    loss, first_ms = _timed(device, lambda: float(loop.step(x, box_t, cls_t)))
    _reset_peak(device)
    steps, losses = [], [loss]
    for _ in range(run["steps"]):
        loss, ms = _timed(device, lambda: float(loop.step(x, box_t, cls_t)))
        steps.append(ms)
        losses.append(loss)
    peak = _peak_gib(device)
    _no_kernels("eager-det", counters)
    masters = {m.dtype for m in opt._master_weights.values()}
    if masters != {torch.float32} or len(opt._master_weights) != sum(
            p.dtype == torch.bfloat16 for p in model.parameters()):
        raise AssertionError(f"[eager-det] master weights {masters}")
    ms = float(np.median(steps))
    log(f"[eager-det] detector, B={B}, {hw} px fp32 images, decorate(O2): "
        f"norms fp32, the rest bf16, {len(opt._master_weights)} fp32 master "
        f"weights; AdamW(1e-3), GradScaler(2**10), auto_cast(O2) | first "
        f"step {first_ms:.1f} ms; steps {', '.join(f'{v:.1f}' for v in steps)}"
        f" ms (median {ms:.1f}) | {B / (ms / 1e3):.1f} imgs/s | peak memory "
        f"{peak:.2f} GiB | scale {scaler._scale:g} | losses "
        f"{[round(v, 4) for v in losses]} | none of the eleven kernels "
        f"launched | {limit}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[eager-det] losses not finite: {losses}")
    del model, opt, loop
    gc.collect()
    _empty(device)
    return {"step_ms": ms, "peak": peak}


class TinyDetector(torch.nn.Module):
    """tests/test_detection_amp.py's detector on the port: two strided
    3x3 convs with ReLUs, 1x1 box (4) and class (3) heads; the loss
    ``mean|box - box_t| + BCE-with-logits(cls, cls_t)``."""

    def __init__(self, device, num_classes=3):
        super().__init__()
        from paddle_tpu_torch import nn

        self.backbone = nn.Sequential(
            nn.Conv2D(3, 16, 3, stride=2, padding=1, device=device),
            nn.ReLU(),
            nn.Conv2D(16, 32, 3, stride=2, padding=1, device=device),
            nn.ReLU())
        self.box_head = nn.Conv2D(32, 4, 1, device=device)
        self.cls_head = nn.Conv2D(32, num_classes, 1, device=device)

    def forward(self, x, box_t, cls_t):
        from paddle_tpu_torch.nn import functional as F

        f = self.backbone(x)
        return torch.abs(self.box_head(f) - box_t).mean() + \
            F.binary_cross_entropy_with_logits(self.cls_head(f), cls_t)


def _eager_leg(dev, make, state, batch, level, lr):
    """3 eager steps of ``make(dev)`` from ``state``; (losses, scaler
    state, the update: for each parameter its fp32 weight's change (the
    master weight's under O2), the spacing of fp32 numbers at its weight
    before the steps, and its accumulators, all on the CPU)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.models import load_numpy_state

    model = make(dev)
    load_numpy_state(model, state)
    model.train()
    opt = optimizer.Momentum(learning_rate=lr, momentum=0.9,
                             parameters=model.parameters(),
                             weight_decay=optimizer.L2Decay(1e-4))
    if level == "O2":
        model, opt = amp.decorate(models=model, optimizers=opt, level="O2")
    loop = EagerLoop(model, opt, amp.GradScaler(init_loss_scaling=2.0 ** 10),
                     batch[0], level=level)
    args = [t.to(dev) for t in batch[1:]]
    params = list(model.parameters())
    before = [p.detach().to("cpu", torch.float32, copy=True)
              for p in params]
    losses = [float(loop.step(*args)) for _ in range(3)]
    update = [((opt._master_weights.get(id(p), p).detach().float().cpu()
                - b), torch.nextafter(b.abs(), torch.tensor(np.inf))
               - b.abs(),
               {k: v.detach().float().cpu()
                for k, v in opt._accumulators.get(id(p), {}).items()
                if torch.is_tensor(v)})
              for p, b in zip(params, before)]
    return losses, loop.scaler.state_dict(), update


def _update_err(got, want):
    """How far one leg's update is from another's, over all the
    parameters together: ||change - change'|| over ||change'|| (no less
    than 4 fp32 spacings at the weights, an update below fp32's
    resolution being its rounding) and, per accumulator slot, ||acc -
    acc'|| over ||acc'||.  A skipped update gives 1, one off by a factor
    k gives |k - 1|.  (Tensor by tensor, a batch norm's weight and bias
    changes are sums that cancel and part far more between two summation
    orders.)"""
    d = n = s = 0.0
    acc = {}
    for (dg, _, ag), (dw, sp, aw) in zip(got, want):
        if set(ag) != set(aw):
            raise AssertionError(f"[eager-parity] accumulators {sorted(ag)}"
                                 f" vs {sorted(aw)}")
        d += float(((dg - dw) ** 2).sum())
        n += float((dw ** 2).sum())
        s += float((sp ** 2).sum())
        for k in aw:
            a = acc.setdefault(k, [0.0, 0.0])
            a[0] += float(((ag[k] - aw[k]) ** 2).sum())
            a[1] += float((aw[k] ** 2).sum())
    return {"update": d ** 0.5 / max(n ** 0.5, 4 * s ** 0.5),
            "accumulators": max((a / b) ** 0.5 for a, b in acc.values())}


def phase_eager_parity(device, lr=1e-5):
    """17c: the eager loop, the card against the CPU (module docstring)."""
    from paddle_tpu_torch import amp, io, optimizer
    from paddle_tpu_torch.testing import faults
    from paddle_tpu_torch.vision.models import resnet18

    cpu = torch.device("cpu")
    rng = np.random.RandomState(0)
    res_batch = (_ce_loss, torch.as_tensor(rng.randn(4, 3, 64, 64).astype(
        np.float32)), torch.as_tensor(rng.randint(0, 10, (4,))))
    det_batch = (_det_loss,
                 torch.as_tensor(rng.randn(2, 3, 32, 32).astype(np.float32)),
                 torch.as_tensor(rng.randn(2, 4, 8, 8).astype(np.float32)),
                 torch.as_tensor((rng.rand(2, 3, 8, 8) > 0.5).astype(
                     np.float32)))
    models = {"resnet18": (lambda d: resnet18(num_classes=10, device=d),
                           res_batch),
              "tiny detector": (lambda d: TinyDetector(d), det_batch)}
    counters = _unet_train_counters()
    _zero_counts(counters)
    worst, lines = {}, []
    for name, (make, batch) in models.items():
        state = {k: v.detach().numpy().copy()
                 for k, v in make(cpu).state_dict().items()}
        for level, rtol, utol in (("O0", 1e-4, 0.1), ("O1", 2e-2, 0.25),
                                  ("O2", 2e-2, 0.25)):
            got, gs, gu = _eager_leg(device, make, state, batch, level, lr)
            want, ws, wu = _eager_leg(cpu, make, state, batch, level, lr)
            err = float(np.max(np.abs(np.array(got) / np.array(want) - 1)))
            upd = _update_err(gu, wu)
            worst[f"{name} {level}"] = err
            lines.append(f"{name} {level}: card {[round(v, 5) for v in got]}"
                         f" cpu {[round(v, 5) for v in want]} rel "
                         f"{err:.2e} (limit {rtol:g}); the weights' change "
                         f"{upd['update']:.2e}, the accumulators "
                         f"{upd['accumulators']:.2e} (limit {utol:g})")
            if not (err <= rtol and max(upd.values()) <= utol) or gs != ws:
                raise AssertionError(f"[eager-parity] {name} {level}: "
                                     f"{lines[-1]}; scaler {gs} vs {ws}")
    # a found-inf step changes nothing, bit for bit
    model = resnet18(num_classes=10, device=device)
    model.train()
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=model.parameters())
    scaler = amp.GradScaler()
    loop = EagerLoop(model, opt, scaler, _ce_loss, level="O1")
    x, y = res_batch[1].to(device), res_batch[2].to(device)
    loop.step(x, y)
    before = [p.detach().clone() for p in model.parameters()]
    acc = {k: v.clone() for k, v in opt.state_dict()["accumulators"].items()
           if torch.is_tensor(v)}
    with amp.auto_cast(level="O1"):
        loss = _ce_loss(model, x, y)
    scaler.scale(loss).backward()
    scaler.mark_found_inf()
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    same = all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    same_acc = all(torch.equal(v, opt.state_dict()["accumulators"][k])
                   for k, v in acc.items())
    if not (same and same_acc and scaler._scale == 2.0 ** 15):
        raise AssertionError("[eager-parity] a mark_found_inf step moved "
                             "the parameters or accumulators")
    # the loader: workers give the in-process batches; a fault names its batch
    rng = np.random.RandomState(1)
    ds = io.TensorDataset([rng.randn(40, 3, 8, 8).astype(np.float32),
                           np.arange(40)])
    runs = []
    for workers in (0, 2):
        np.random.seed(3)
        runs.append(list(io.DataLoader(ds, batch_size=6, shuffle=True,
                                       num_workers=workers, places=device)))
    equal = len(runs[0]) == len(runs[1]) == 7 and all(
        torch.equal(a, b) for x0, x1 in zip(*runs) for a, b in zip(x0, x1))
    faults.reset("io.worker:before:2=raise")
    try:
        list(io.DataLoader(ds, batch_size=6, num_workers=1, places=device))
        err = None
    except io.DataLoaderWorkerError as e:
        err = e
    finally:
        faults.disarm_all()
    _no_kernels("eager-parity", counters)
    log(f"[eager-parity] card vs CPU, lr {lr}, 3 eager steps a leg: "
        + "; ".join(lines) + f" | scaler states equal | mark_found_inf: "
        f"parameters and {len(acc)} accumulators bit for bit, scale 2**16 "
        f"-> {scaler._scale:g} | 2-worker loader = 0-worker: {equal} | "
        f"armed io.worker: {err}")
    if not equal or err is None or err.indices != list(range(6, 12)):
        raise AssertionError(f"[eager-parity] loader: equal {equal}, "
                             f"error {err}")
    _empty(device)
    return worst


ZOO = (("vgg16", {}, 224), ("alexnet", {}, 224),
       ("lenet", {}, 28), ("mobilenet_v1", {}, 224),
       ("mobilenet_v2", {}, 224), ("mobilenet_v3_large", {}, 224),
       ("mobilenet_v3_small", {}, 224), ("squeezenet1_1", {}, 224),
       ("shufflenet_v2_x1_0", {}, 224), ("densenet121", {}, 224),
       ("googlenet", {}, 224), ("inception_v3", {}, 299),
       ("resnet50", {}, 224))


def phase_zoo(device, limit, models=ZOO):
    """17d: the zoo (module docstring); ``models`` as ``ZOO``."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.models import load_numpy_state
    from paddle_tpu_torch.vision import models as zoo

    cpu = torch.device("cpu")
    counters = _unet_train_counters()
    _zero_counts(counters)
    errs, lines = {}, []
    for name, kw, hw in models:
        ctor = zoo.LeNet if name == "lenet" else getattr(zoo, name)
        kw = dict(kw) if name == "lenet" else dict(kw, num_classes=1000)
        chans = 1 if name == "lenet" else 3
        x = torch.as_tensor(np.random.RandomState(0).randn(
            2, chans, hw, hw).astype(np.float32))
        t0 = time.perf_counter()
        card = ctor(device=device, seed=0, **kw)
        ref = ctor(device=cpu, seed=1, **kw)
        load_numpy_state(ref, {k: v.detach().cpu().numpy() for k, v in
                               card.state_dict().items()})
        card.eval()
        ref.eval()
        with torch.no_grad():
            got = card(x.to(device))
            want = ref(x)
        errs[name] = _max_rel(got, want)
        del ref
        card.train()
        opt = optimizer.SGD(learning_rate=0.01,
                            parameters=card.parameters())
        loop = EagerLoop(card, opt, amp.GradScaler(), _ce_loss, level="O1")
        y = torch.arange(2, device=device) * 7
        loss = float(loop.step(x.to(device), y))
        n = sum(p.numel() for p in card.parameters())
        lines.append(f"{name} ({n / 1e6:.2f} M, {hw} px): logits "
                     f"{errs[name]:.2e} of the largest, O1 step loss "
                     f"{loss:.4f} ({time.perf_counter() - t0:.1f} s)")
        if not (errs[name] <= 1e-5 and np.isfinite(loss)):
            raise AssertionError(f"[zoo] {lines[-1]} (limit 1e-5)")
        del card, opt, loop
    _no_kernels("zoo", counters)
    log("[zoo] eval fp32 card vs CPU at B=2, then one O1 step on the card: "
        + "; ".join(lines) + f" | none of the eleven kernels launched | "
        f"{limit}")
    gc.collect()
    _empty(device)
    return errs


#: 18's eval: PaddleDetection's PP-YOLOE+ MultiClassNMS settings
#: (nms_top_k 1000, keep_top_k 300, nms_threshold 0.7) on phase 13's
#: detector (stride 32, 80 classes) at B = 64, 320 px
DET_EVAL = dict(batch=64, image=320, stride=32, top=1000, keep=300,
                iou=0.7)


def det_candidates(box, cls, stride, top):
    """The eval decode of tests/test_detection_amp.py:84-92 at stride
    ``stride``: cell centres ``(i + 1/2) * stride``, boxes ``centre -+
    |offset| * stride`` (the offsets in stride units, as the anchor-free
    heads decode their distances), rounded to 1/16 px so that the
    category offset of nms's fixed-size route is exact in fp32; scores
    the sigmoid of the class logits in fp32.  Per image the ``top``
    (class, cell) pairs by a stable descending sort: (boxes [B, top, 4],
    scores [B, top], classes [B, top])."""
    B, _, H, W = box.shape
    dev = box.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    centre = (torch.stack([xs, ys, xs, ys]).reshape(4, -1).T.float()
              + 0.5) * stride                                   # [HW, 4]
    off = box.float().abs().reshape(B, 4, -1).transpose(1, 2) * stride
    boxes = torch.cat([centre[None, :, :2] - off[..., :2],
                       centre[None, :, 2:] + off[..., 2:]], -1)
    boxes = torch.round(boxes * 16) / 16
    scores = torch.sigmoid(cls.float()).reshape(B, -1)      # class-major
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :top]
    cell = order % (H * W)
    cand = boxes.gather(1, cell[..., None].expand(-1, -1, 4))
    return cand, scores.gather(1, order), order // (H * W)


def _eager_nms(cand, scores, classes, run):
    from paddle_tpu_torch.vision import ops as vops

    return [vops.nms(cand[i], run["iou"], scores[i], classes[i],
                     top_k=run["keep"]) for i in range(cand.shape[0])]


def _near_threshold(cand, classes, thr, eps=1e-6):
    """Per image: whether some pair of its boxes of one class has an IoU
    (float64) within ``eps`` of ``thr`` (where fp32 and fp64 may take
    opposite sides)."""
    from paddle_tpu_torch.vision import ops as vops

    b = vops._category_shift(cand.double(), classes)
    iou = vops._iou_matrix(b)
    n = iou.shape[-1]
    iou = iou.masked_fill(torch.eye(n, dtype=torch.bool,
                                    device=iou.device), -1.0)
    return ((iou - thr).abs() < eps).flatten(1).any(1)


def phase_detection_eval(device, limit, run=None):
    """18a: BASELINE config 4's eval side (module docstring)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.vision import ops as vops

    run = dict(DET_EVAL, **(run or {}))
    B, hw, keep = run["batch"], run["image"], run["keep"]
    counters = _unet_train_counters()
    _zero_counts(counters)
    model = amp.decorate(models=Detector(device), level="O2")
    model.eval()
    x = torch.as_tensor(np.random.RandomState(0).randn(
        B, 3, hw, hw).astype(np.float32), device=device)

    def forward():
        with torch.no_grad(), amp.auto_cast(level="O2"):
            return model.heads(x)

    def decode_nms():
        cand, scores, classes = det_candidates(*heads, run["stride"],
                                               run["top"])
        return cand, scores, classes, _eager_nms(cand, scores, classes,
                                                 run)
    heads = forward()                       # cuDNN's first calls
    heads, fwd_ms = _timed(device, forward)
    if {heads[0].dtype, heads[1].dtype} != {torch.bfloat16}:
        raise AssertionError(f"[det-eval] heads {heads[0].dtype}, "
                             f"{heads[1].dtype}: O2 computes in bf16")
    decode_nms()
    (cand, scores, classes, kept), nms_ms = _timed(device, decode_nms)
    # the same fp32 candidates through the eager route on the CPU
    cpu = _eager_nms(cand.cpu(), scores.cpu(), classes.cpu(), run)
    bad = [i for i in range(B) if not torch.equal(kept[i].cpu(), cpu[i])]
    if bad:
        raise AssertionError(f"[det-eval] eager nms card != CPU in images "
                             f"{bad[:8]}")
    # the fixed-size route, captured in a CUDA graph and replayed
    sb, ss, sc = cand.clone(), scores.clone(), classes.clone()
    side = torch.cuda.Stream() if device.type == "cuda" else None

    def fixed_route():
        one = vops.nms(sb[0], run["iou"], ss[0], sc[0], top_k=keep)
        return one, vops._nms_device(vops._category_shift(sb, sc), ss,
                                     run["iou"], keep)
    if side is not None:
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fixed_route()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            one, fixed = fixed_route()
        capture_s = time.perf_counter() - t0
        graph.replay()
        _, replay_ms = _timed(device, graph.replay)
        if one.shape != (keep,) or not torch.equal(one, fixed[0]):
            raise AssertionError("[det-eval] nms under capture is not the "
                                 "fixed-size route of image 0")
    else:
        (one, fixed), replay_ms = _timed(device, fixed_route)
        capture_s = 0.0
    near = _near_threshold(cand, classes, run["iou"]).cpu()
    counts = [len(k) for k in kept]
    for i in range(B):
        if near[i]:
            continue
        want = torch.full((keep,), -1, dtype=torch.int64)
        want[:counts[i]] = kept[i].cpu()
        if not torch.equal(fixed[i].cpu(), want):
            raise AssertionError(f"[det-eval] image {i}: the fixed-size "
                                 f"route differs from the eager one")
    _no_kernels("det-eval", counters)
    ms = fwd_ms + nms_ms
    log(f"[det-eval] detector eval, B={B}, {hw} px, decorate(O2) + "
        f"auto_cast(O2): forward {fwd_ms:.2f} ms | decode + class-aware "
        f"nms (top {run['top']} of {heads[1].shape[1]} classes x "
        f"{heads[1].shape[2] * heads[1].shape[3]} cells, IoU {run['iou']}, "
        f"keep {keep}), eager float64: {nms_ms:.2f} ms, kept "
        f"{min(counts)}-{max(counts)} an image (mean "
        f"{np.mean(counts):.1f}), equal to the CPU's | {B / (ms / 1e3):.1f}"
        f" images/s | fixed-size float32 route in a CUDA graph (captured "
        f"in {capture_s:.2f} s): replay {replay_ms:.2f} ms for the batch, "
        f"equal to the eager route in {B - int(near.sum())} images, "
        f"{int(near.sum())} exempt (an IoU within 1e-6 of the threshold) "
        f"| none of the eleven kernels launched | {limit}")
    del model, heads
    _empty(device)
    return {"fwd_ms": fwd_ms, "nms_ms": nms_ms, "replay_ms": replay_ms,
            "imgs_per_s": B / (ms / 1e3)}


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _op_on_both(tag, fn, args, flush, iters=5, cpu_fn=None, timed=None):
    """``fn`` on the card's ``args`` and ``cpu_fn`` (default ``fn``) on
    their CPU copies: every float output within 1e-5 of the largest
    magnitude of the CPU's (at least 1), every other output equal; then
    ``fn`` timed on the card at ``timed`` (default ``args``): mean ms of
    ``iters`` calls after a warm-up, CUDA events, L2 flushed.  Returns
    (ms, largest relative error, the CPU's seconds)."""
    def cpu(a):
        return a.cpu() if isinstance(a, torch.Tensor) else a
    got = _flat(fn(*args))
    t0 = time.perf_counter()
    want = _flat((cpu_fn or fn)(*[cpu(a) for a in args]))
    cpu_s = time.perf_counter() - t0
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"[det-ops] {tag}: shape {tuple(g.shape)}"
                                 f" on the card, {tuple(w.shape)} on the "
                                 f"CPU")
        if w.is_floating_point():
            d = float((g.detach().cpu().double() - w.detach().double())
                      .abs().max()) if w.numel() else 0.0
            scale = max(1.0, float(w.abs().max()) if w.numel() else 1.0)
            err = max(err, d / scale)
        elif not torch.equal(g.cpu(), w):
            raise AssertionError(f"[det-ops] {tag}: integer outputs differ")
    if err > 1e-5:
        raise AssertionError(f"[det-ops] {tag}: {err:.2e} of the largest "
                             f"value (limit 1e-5)")
    timed = args if timed is None else timed
    if args and isinstance(args[0], torch.Tensor) and args[0].is_cuda:
        ms = time_ms(lambda: fn(*timed), flush, iters=iters, warmup=1)
    else:
        ms = float("nan")
    return ms, err, cpu_s


def _rois(rng, n, img_h, img_w, lo, hi):
    """``n`` boxes with sqrt-area uniform in [lo, hi] px and aspect in
    [1/2, 2], centres uniform in the image."""
    s = rng.uniform(lo, hi, n)
    ar = np.exp(rng.uniform(np.log(0.5), np.log(2.0), n))
    w, h = s * np.sqrt(ar), s / np.sqrt(ar)
    cx, cy = rng.uniform(0, img_w, n), rng.uniform(0, img_h, n)
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                    1).astype(np.float32)


def _rpn_anchors(H, W, stride, sizes=(32, 64, 128, 256, 512),
                 ratios=(0.5, 1.0, 2.0)):
    """Faster R-CNN's anchors ``[H, W, A, 4]``: every size and ratio at
    every cell centre."""
    wh = np.array([(s * np.sqrt(1 / r), s * np.sqrt(r)) for s in sizes
                   for r in ratios])
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    c = (np.stack([xs, ys], -1)[:, :, None, :] + 0.5) * stride
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def phase_detection_ops(device, limit, sizes=None):
    """18b: each op at a published size, card against the port on the
    CPU (module docstring); ``sizes`` shrinks the shapes for a rehearsal
    (a dict of overrides, see DET_OPS)."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.models import load_numpy_state
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision import ops as vops

    z = dict(DET_OPS, **(sizes or {}))
    counters = _unet_train_counters()
    _zero_counts(counters)
    cpu = torch.device("cpu")
    flush = (torch.empty(256 * 1024 * 1024, dtype=torch.uint8,
                         device=device) if device.type == "cuda" else None)
    rng = np.random.RandomState(0)

    def dev(a):
        return torch.as_tensor(a, device=device)
    rows = []

    def hold(tag, fn, *args, cpu_fn=None, timed=None):
        ms, err, cpu_s = _op_on_both(tag, fn, args, flush, cpu_fn=cpu_fn,
                                     timed=timed)
        rows.append(f"{tag} {ms:.3f} ms ({err:.1e}; CPU {cpu_s:.2f} s)")
        return ms
    # roi_align over a Mask R-CNN FPN P2 map (stride 4), ROIs of P2's
    # scale range, 512 an image, timed at all of them; card and CPU are
    # held on the first ``rois_held`` of each image (ROIs are
    # independent), to keep the CPU leg short
    n_img, C, H, W = z["p2"]
    x = dev(rng.randn(n_img, C, H, W).astype(np.float32))
    per = [_rois(rng, z["rois"], H * 4, W * 4, 16, 112)
           for _ in range(n_img)]
    full = (x, dev(np.concatenate(per)),
            dev(np.full(n_img, z["rois"], np.int32)))
    held = (x, dev(np.concatenate([b[:z["rois_held"]] for b in per])),
            dev(np.full(n_img, z["rois_held"], np.int32)))
    for out, ratio in ((7, -1), (7, 2), (14, -1), (14, 2)):
        hold(f"roi_align {out}x{out} ratio {ratio}",
             lambda a, b, n, o=out, r=ratio: vops.roi_align(
                 a, b, n, o, 0.25, r, True), *held, timed=full)
    hold("roi_pool 7x7", lambda a, b, n: vops.roi_pool(a, b, n, 7, 0.25),
         *held, timed=full)
    del x, full, held
    n_img, C, H, W = z["rfcn"]
    xs = dev(rng.randn(n_img, C, H, W).astype(np.float32))
    rb = dev(np.concatenate([_rois(rng, z["rfcn_rois"], H * 16, W * 16, 32,
                                   400) for _ in range(n_img)]))
    hold("psroi_pool 7x7", lambda a, b, n: vops.psroi_pool(a, b, n, 7,
                                                           1 / 16),
         xs, rb, dev(np.full(n_img, z["rfcn_rois"], np.int32)))
    del xs
    # YOLOv3's three 608-px heads, 80 classes
    B = z["yolo_batch"]
    img = dev(np.full((B, 2), 608, np.int32))
    for side, an in ((19, [116, 90, 156, 198, 373, 326]),
                     (38, [30, 61, 62, 45, 59, 119]),
                     (76, [10, 13, 16, 30, 33, 23])):
        hold(f"yolo_box {side}x{side}",
             lambda a, i, an=an, s=side: vops.yolo_box(
                 a, i, an, 80, 0.005, 608 // s),
             dev(rng.randn(B, 255, side, side).astype(np.float32)), img)
    # RPN proposals: a C4 map at stride 16 of an 800 x 1344 image
    N, A, H, W = z["rpn"]
    anchors = dev(_rpn_anchors(H, W, 16))
    hold("generate_proposals 2000/1000",
         lambda s, d, i, a, v: vops.generate_proposals(
             s, d, i, a, v, pre_nms_top_n=2000, post_nms_top_n=1000,
             nms_thresh=0.7, min_size=0.0, return_rois_num=True),
         dev(rng.rand(N, A, H, W).astype(np.float32)),
         dev((rng.randn(N, 4 * A, H, W) * 0.3).astype(np.float32)),
         dev(np.full((N, 2), (H * 16, W * 16), np.float32)), anchors,
         dev(np.ones((H, W, A, 4), np.float32)))
    N, M = z["matrix"]
    mb = _rois(rng, N * M, 640, 640, 8, 200).reshape(N, M, 4)
    hold("matrix_nms 80 classes",
         lambda b, s: vops.matrix_nms(
             b, s, 0.01, post_threshold=0.01, nms_top_k=500,
             keep_top_k=100, use_gaussian=True, gaussian_sigma=2.0,
             background_label=-1, normalized=False, return_index=True),
         dev(mb), dev(rng.rand(N, 80, M).astype(np.float32)))
    # PP-YOLOv2's DCN stage: deform_conv2d v2 at [8, 512, 19, 19], 3x3
    B, C, S = z["dcn"]
    dcn = vops.DeformConv2D(C, C, 3, padding=1, device=device)
    hold("deform_conv2d v2", lambda a, o, m, w, b: vops.deform_conv2d(
        a, o, w, b, padding=1, mask=m),
        dev(rng.randn(B, C, S, S).astype(np.float32)),
        dev((rng.randn(B, 18, S, S) * 2).astype(np.float32)),
        dev(rng.rand(B, 9, S, S).astype(np.float32)),
        dcn.weight.detach(), dcn.bias.detach())
    # convolutions at UNet / sequence / video sizes
    for tag, ctor, kw, shape in z["convs"]:
        layer = getattr(pnn, ctor)(**kw, device=device)
        twin = getattr(pnn, ctor)(**kw, device=cpu)
        load_numpy_state(twin, {k: v.detach().cpu().numpy()
                                for k, v in layer.state_dict().items()})
        with torch.no_grad():
            hold(tag, layer, dev(rng.randn(*shape).astype(np.float32)),
                 cpu_fn=twin)
    # pools: indices and unpool (SegNet), ceil mode
    shape = z["pool"]
    xp = dev(rng.randn(*shape).astype(np.float32))
    hold("max_pool2d return_mask + max_unpool2d", lambda a: (
        lambda v, i: (v, i, F.max_unpool2d(v, i, 2, 2)))(
        *F.max_pool2d(a, 2, 2, return_mask=True)), xp)
    hold("avg_pool2d 3x3/2 ceil_mode", lambda a: F.avg_pool2d(
        a[..., 1:, 1:], 3, 2, ceil_mode=True), xp)
    hold("max_pool3d 2/2 ceil_mode", lambda a: F.max_pool3d(
        a, 2, 2, ceil_mode=True),
        dev(rng.randn(*z["pool3d"]).astype(np.float32)))
    del xp
    xi = dev(rng.randn(*z["image"]).astype(np.float32))
    side = z["image"][-1]
    hold(f"bicubic {side} -> {2 * side}", lambda a: F.interpolate(
        a, size=(2 * side, 2 * side), mode="bicubic"), xi)
    hold(f"bicubic {side} -> {side // 2}", lambda a: F.interpolate(
        a, size=(side // 2, side // 2), mode="bicubic"), xi)
    hold("gelu tanh", lambda a: F.gelu(a, approximate=True),
         dev(rng.randn(*z["gelu"]).astype(np.float32)))
    _no_kernels("det-ops", counters)
    log("[det-ops] card vs the port on the CPU, each within 1e-5 of the "
        "largest value (integers equal), card ms (mean of 5, L2 flushed), "
        "error, the CPU leg's seconds: "
        + "; ".join(rows) + f" | none of the eleven kernels launched | "
        f"{limit}")
    _empty(device)
    return rows


#: 18b's shapes: a Mask R-CNN FPN P2 map of an 800 x 1344 image with 512
#: ROIs an image; R-FCN's 7 x 7 x 81 position-sensitive maps at stride 16
#: of a 600 x 1000 image, 300 ROIs an image; YOLOv3 at 608 px, B = 8; a
#: C4 RPN (15 anchors) at stride 16 of 800 x 1344; PP-YOLOE+'s 8400
#: boxes at 640 px; PP-YOLOv2's DCN stage; a UNet up-sampling conv, a
#: sequence conv, a C3D-size 3-d conv and its transpose; SegNet's pools
DET_OPS = dict(
    p2=(2, 256, 200, 336), rois=512, rois_held=64, rfcn=(2, 3969, 38, 63), rfcn_rois=300,
    yolo_batch=8, rpn=(2, 15, 50, 84), matrix=(2, 8400),
    dcn=(8, 512, 19),
    convs=(("Conv2DTranspose 256->128 k2 s2 [4, 256, 64, 64]",
            "Conv2DTranspose", dict(in_channels=256, out_channels=128,
                                    kernel_size=2, stride=2),
            (4, 256, 64, 64)),
           ("Conv1D 256->256 k3 [8, 256, 1024]", "Conv1D",
            dict(in_channels=256, out_channels=256, kernel_size=3,
                 padding=1), (8, 256, 1024)),
           ("Conv3D 64->64 k3 [2, 64, 16, 56, 56]", "Conv3D",
            dict(in_channels=64, out_channels=64, kernel_size=3,
                 padding=1), (2, 64, 16, 56, 56)),
           ("Conv3DTranspose 64->32 k2 s2 [2, 64, 8, 28, 28]",
            "Conv3DTranspose", dict(in_channels=64, out_channels=32,
                                    kernel_size=2, stride=2),
            (2, 64, 8, 28, 28))),
    pool=(16, 64, 112, 112), pool3d=(2, 64, 15, 55, 55),
    image=(8, 3, 224, 224), gelu=(64, 197, 3072))


# -- phase 19: the op namespace ---------------------------------------------

#: 19a's ops: (name, arguments after the tensor ones, number of tensor
#: arguments, input range, differentiable).  The inputs are seeded numpy
#: arrays of NS_SHAPE, the same on both devices.
NS_SHAPE = (6, 8, 4)
NS_UNARY = [
    ("exp", 1), ("expm1", 1), ("log", 2), ("log2", 2), ("log10", 2),
    ("log1p", 2), ("sqrt", 2), ("rsqrt", 2), ("square", 1), ("abs", 1),
    ("neg", 1), ("sign", 0), ("floor", 0), ("ceil", 0), ("trunc", 0),
    ("frac", 1), ("reciprocal", 2), ("sin", 1), ("cos", 1), ("tan", 1),
    ("asin", 3), ("acos", 3), ("atan", 1), ("sinh", 1), ("cosh", 1),
    ("asinh", 1), ("atanh", 3), ("erf", 1), ("erfinv", 3), ("lgamma", 2),
    ("digamma", 2), ("i0", 1), ("isnan", 0), ("isinf", 0),
    ("isfinite", 0), ("logical_not", 0), ("tanh", 1), ("sigmoid", 1),
    ("relu", 1), ("relu6", 1), ("silu", 1), ("gelu", 1),
    ("leaky_relu", 1), ("elu", 1), ("selu", 1), ("celu", 1),
    ("softplus", 1), ("softsign", 1), ("hardtanh", 1),
    ("hardsigmoid", 1), ("hardswish", 1), ("mish", 1), ("tanhshrink", 1),
    ("softshrink", 1), ("hardshrink", 1), ("thresholded_relu", 1),
    ("log_sigmoid", 1), ("stanh", 1), ("nan_to_num", 0), ("softmax", 1),
    ("log_softmax", 1)]
NS_BINARY = ["add", "subtract", "multiply", "divide", "pow", "maximum",
             "minimum", "remainder", "floor_divide", "fmax", "fmin",
             "logaddexp", "atan2", "equal", "not_equal", "greater_than",
             "greater_equal", "less_than", "less_equal", "isclose"]
NS_INT_BINARY = ["add", "multiply", "floor_divide", "remainder", "gcd",
                 "lcm", "bitwise_and", "bitwise_or", "bitwise_xor",
                 "left_shift", "right_shift", "maximum", "divide"]


def _ns_cases(P, rng):
    """{name: (fn, numpy inputs, differentiable)} of 19a, from the
    package ``P`` (the port)."""
    shape = NS_SHAPE
    ranges = {0: (-3.0, 3.0), 1: (-2.0, 2.0), 2: (0.2, 3.0),
              3: (-0.9, 0.9)}

    def arr(lo, hi, sh=shape):
        return rng.uniform(lo, hi, sh).astype(np.float32)

    x, y = arr(-2, 2), arr(0.5, 2)
    xi = rng.integers(-5, 9, shape).astype(np.int32)
    yi = rng.integers(1, 6, shape).astype(np.int64)
    xb = rng.random(shape) > 0.5
    idx = np.array([3, 0, 3, 5], np.int64)
    cases = {}
    for op, r in NS_UNARY:
        cases[op] = (getattr(P, op), [arr(*ranges[r])], r > 0)
    for op in ("abs", "neg", "square", "sqrt", "exp", "floor",
               "bitwise_not", "sign"):
        cases[f"{op}[i32]"] = (getattr(P, op), [xi], False)
    for op in NS_BINARY:
        cases[op] = (getattr(P, op), [x, y], op not in (
            "remainder", "floor_divide", "fmax", "fmin", "equal",
            "not_equal", "greater_than", "greater_equal", "less_than",
            "less_equal", "isclose"))
        cases[f"{op}[bcast]"] = (getattr(P, op), [x, y[:1, :, :1]], False)
    for op in NS_INT_BINARY:
        cases[f"{op}[i32_i64]"] = (getattr(P, op), [np.abs(xi) % 7, yi],
                                   False)
    for op in ("add", "multiply", "divide", "less_than"):
        cases[f"{op}[i32_pyfloat]"] = (
            lambda a, op=op: getattr(P, op)(a, 2.5), [xi], False)
        cases[f"{op}[f32_npf64]"] = (
            lambda a, op=op: getattr(P, op)(a, np.float64(1.5)), [x], False)
    for op in ("logical_and", "logical_or", "logical_xor"):
        cases[op] = (getattr(P, op), [xb, ~xb], False)
    cases["clip"] = (lambda a: P.clip(a, -0.5, 0.7), [x], True)
    cases["scale"] = (lambda a: P.scale(a, 2.0, 0.5), [x], True)
    cases["lerp"] = (P.lerp, [x, y, arr(0, 1)], True)
    for op in ("sum", "mean", "max", "min", "amax", "amin", "prod",
               "logsumexp", "nansum", "nanmean", "median", "var", "std",
               "quantile"):
        extra = (0.3,) if op == "quantile" else ()
        cases[f"{op}[all]"] = (lambda a, op=op, e=extra: getattr(P, op)(
            a, *e), [x], True)
        cases[f"{op}[axis]"] = (lambda a, op=op, e=extra: getattr(P, op)(
            a, *e, axis=2), [x], True)
        if op not in ("prod", "quantile"):
            cases[f"{op}[keep]"] = (lambda a, op=op: getattr(P, op)(
                a, axis=[0, 2], keepdim=True), [x], True)
    for op in ("sum", "mean", "max", "prod", "median", "var"):
        cases[f"{op}[i32]"] = (lambda a, op=op: getattr(P, op)(a, axis=1),
                               [xi], False)
    for op in ("any", "all"):
        cases[op] = (lambda a, op=op: getattr(P, op)(a, axis=1), [xb], False)
    for op in ("argmax", "argmin", "cumsum", "cumprod", "cummax", "cummin"):
        cases[op] = (lambda a, op=op: getattr(P, op)(a, 1), [x],
                     op in ("cumsum", "cumprod"))
        cases[f"{op}[flat]"] = (getattr(P, op), [xi], False)
    cases["count_nonzero"] = (lambda a: P.count_nonzero(a, 1), [xi], False)
    cases["numel"] = (P.numel, [x], False)
    manip = {
        "cast": lambda a: P.cast(a, "int32"),
        "reshape": lambda a: P.reshape(a, [4, -1]),
        "transpose": lambda a: P.transpose(a, [2, 0, 1]),
        "t": lambda a: P.t(a[0]),
        "squeeze": lambda a: P.squeeze(a[:, :1], 1),
        "unsqueeze": lambda a: P.unsqueeze(a, [0, -1]),
        "flatten": lambda a: P.flatten(a, 1, 2),
        "expand": lambda a: P.expand(a[:, :1], [2, 6, 8, 4]),
        "tile": lambda a: P.tile(a, [2, 1, 1]),
        "concat": lambda a: P.concat([a, a[:, :2]], 1),
        "stack": lambda a: P.stack([a, a], 2),
        "split": lambda a: P.split(a, [2, -1, 3], 1),
        "chunk": lambda a: P.chunk(a, 2, 2),
        "unstack": lambda a: P.unstack(a, 0),
        "flip": lambda a: P.flip(a, [0, 2]),
        "roll": lambda a: P.roll(a, [1, -2], [0, 2]),
        "pad": lambda a: P.pad(a, [1, 2], "constant", 0.5),
        "pad[reflect]": lambda a: P.pad(a, [2, 1], "reflect"),
        "gather": lambda a: P.gather(a, P.to_tensor(idx, place=a.device),
                                     1),
        "take_along_axis": lambda a: P.take_along_axis(
            a, P.to_tensor(np.arange(8).reshape(1, 8, 1) % 3,
                           place=a.device), 2),
        "put_along_axis": lambda a: P.put_along_axis(
            a, P.to_tensor(np.arange(8).reshape(1, 8, 1) % 3,
                           place=a.device), 9.0, 2),
        "scatter": lambda a: P.scatter(
            a[:, :, 0], P.to_tensor(np.array([4, 1]), place=a.device),
            a[:2, :, 1]),
        "scatter_nd_add": lambda a: P.scatter_nd_add(
            a, P.to_tensor(np.array([[0, 1], [2, 3]]), place=a.device),
            a[0, :2]),
        "gather_nd": lambda a: P.gather_nd(
            a, P.to_tensor(np.array([[0, 1], [2, 3]]), place=a.device)),
        "where": lambda a: P.where(a > 0, a, -2 * a),
        "masked_fill": lambda a: P.masked_fill(a, a > 0, 2.0),
        "masked_select": lambda a: P.masked_select(a, a > 0.5),
        "topk": lambda a: P.topk(a, 2),
        "sort": lambda a: P.sort(a, 1, True),
        "argsort": lambda a: P.argsort(a, 1),
        "unique": lambda a: P.unique(P.cast(a * 2, "int64"),
                                     return_counts=True),
        "nonzero": lambda a: P.nonzero(a > 1),
        "tril": lambda a: P.tril(a, -1),
        "triu": lambda a: P.triu(a[0], 1),
        "diagonal": lambda a: P.diagonal(a, 0, 1, 2),
        "diag": lambda a: P.diag(a[0, 0]),
        "repeat_interleave": lambda a: P.repeat_interleave(a, 2, 1),
        "moveaxis": lambda a: P.moveaxis(a, 0, 2),
        "slice": lambda a: P.slice(a, [0, 2], [1, -3], [4, 100]),
        "matmul": lambda a: P.matmul(a, P.transpose(a, [0, 2, 1])),
        "one_hot": lambda a: P.one_hot(P.cast(a.abs() * 2, "int64"), 5),
        "meshgrid": lambda a: P.meshgrid(a[0, 0], a[1, 1]),
        "diag_embed": lambda a: P.diag_embed(a[0]),
        "zeros_like": lambda a: P.zeros_like(a),
        "full_like": lambda a: P.full_like(a, 7, "int32"),
    }
    for k, fn in manip.items():
        cases[k] = (fn, [x], k not in (
            "cast", "masked_select", "unique", "nonzero", "one_hot",
            "argsort", "zeros_like", "full_like"))
    return cases


def _ns_leaves(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _ns_close(tag, got, want, tol):
    """got (card) against want (CPU): dtype, shape, values."""
    if got.dtype != want.dtype or tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"[namespace] {tag}: {got.dtype} "
                             f"{tuple(got.shape)} vs {want.dtype} "
                             f"{tuple(want.shape)}")
    g, w = got.detach().cpu(), want.detach()
    if not (w.is_floating_point() or w.is_complex()):
        if not torch.equal(g, w):
            raise AssertionError(f"[namespace] {tag}: integers differ")
        return 0.0
    g, w = g.double(), w.double()
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
        raise AssertionError(f"[namespace] {tag}: NaN positions differ")
    ok = ~torch.isnan(w)
    if not bool(ok.any()):
        return 0.0
    fin = ok & torch.isfinite(w)
    scale = max(1.0, float(w[fin].abs().max())) if bool(fin.any()) else 1.0
    err = float((g[ok] - w[ok]).abs().max()) if bool(ok.any()) else 0.0
    if not err <= tol * scale:
        raise AssertionError(f"[namespace] {tag}: {err:.3e} > "
                             f"{tol:.1e} x {scale:.3g}")
    return err / scale


def _ns_families(P, device, cpu, rng):
    """19a: (ops, comparisons, worst error over the largest value) over
    the ops, fp32 and bf16, values and fp32 gradients."""
    cases = _ns_cases(P, rng)
    sides = (("card", device), ("cpu", cpu))
    n, worst = 0, {"float32": 0.0, "bfloat16": 0.0, "grad": 0.0}
    for tag, (fn, arrays, diff) in cases.items():
        for dt in ("float32", "bfloat16"):
            ins, outs = {}, {}
            for side, d in sides:
                ts = [P.to_tensor(a, place=d) for a in arrays]
                if dt == "bfloat16":
                    ts = [P.cast(t, "bfloat16") if t.is_floating_point()
                          else t for t in ts]
                if dt == "float32" and diff:
                    for t in ts:
                        if t.is_floating_point():
                            t.stop_gradient = False
                ins[side] = ts
                outs[side] = _ns_leaves(fn(*ts))
            tol = 2e-6 if dt == "float32" else 1.6e-2
            for i, (g, w) in enumerate(zip(outs["card"], outs["cpu"])):
                worst[dt] = max(worst[dt], _ns_close(f"{tag}[{dt}] out {i}",
                                                     g, w, tol))
                n += 1
            if dt != "float32" or not diff:
                continue
            for side, d in sides:
                terms = [(o * torch.linspace(-1, 1, o.numel()).reshape(
                    o.shape).to(d)).sum() for o in outs[side]
                    if o.is_floating_point() and o.requires_grad]
                if terms:
                    sum(terms).backward()
            for i, (g, w) in enumerate(zip(ins["card"], ins["cpu"])):
                if w.grad is not None:
                    worst["grad"] = max(worst["grad"], _ns_close(
                        f"{tag} grad {i}", g.grad, w.grad, 2e-6))
                    n += 1
    return len(cases), n, worst


def _ns_inplace(P, device, cpu, rng):
    """19a's in-place leg: each variant on both devices, the same object
    back with the CPU's value and dtype."""
    x = rng.uniform(0.3, 2.0, NS_SHAPE).astype(np.float32)
    xi = rng.integers(1, 9, NS_SHAPE).astype(np.int32)
    calls = [("add_", x, (2.5,)), ("add_", xi, (2.5,)),
             ("multiply_", xi, (x,)), ("divide_", xi, (3,)),
             ("exp_", x, ()), ("sqrt_", xi, ()), ("less_than_", x, (1.0,)),
             ("clip_", x, (0.5, 1.5)), ("scale_", x, (2.0, 1.0)),
             ("cast_", x, ("int64",)), ("reshape_", x, ([4, -1],)),
             ("transpose_", x, ([2, 0, 1],)), ("cumsum_", x, (1,)),
             ("masked_fill_", x, (x > 1, 0.0)), ("tril_", x, ()),
             ("subtract_", x, (x,)), ("floor_divide_", xi, (xi,))]
    for name, a, args in calls:
        res = []
        for d in (device, cpu):
            t = P.to_tensor(a, place=d)
            argv = [P.to_tensor(v, place=d) if isinstance(v, np.ndarray)
                    else v for v in args]
            if getattr(P, name)(t, *argv) is not t:
                raise AssertionError(f"[namespace] {name}: a new object")
            res.append(t)
        _ns_close(f"{name} in place", res[0], res[1], 2e-6)
    return len(calls)


def _ns_mlp(P, place, x, y, init, steps=50, lr=0.1):
    """19d: a user's script, ``paddle.*`` names only.  Returns (losses,
    seconds of the steps)."""
    P.set_device(place)
    P.seed(0)
    xt, yt = P.to_tensor(x), P.to_tensor(y)
    params = [P.create_parameter(list(v.shape), "float32",
                                 default_initializer=lambda p, v=v:
                                 p.set_value(v))
              for v in init]
    w1, b1, w2 = params
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        h = P.tanh(P.add(P.matmul(xt, w1), b1))
        err = P.subtract(P.matmul(h, w2), yt)
        loss = P.mean(P.multiply(err, err))
        loss.backward()
        with P.no_grad():
            for p in params:
                P.subtract_(p, P.scale(p.grad, lr))
                p.clear_grad()
        losses.append(float(loss))
    return losses, time.perf_counter() - t0


def phase_namespace(device, limit):
    """19 (module docstring): the flat op namespace on the card."""
    import paddle_tpu_torch as P

    counters = _unet_train_counters()
    _zero_counts(counters)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    # (e) the place rule: with no place a tensor lies on the card
    if P.get_device() != "gpu:0" or P.ones([2]).device != torch.device(
            "cuda", 0):
        raise AssertionError(f"[namespace] the current place is "
                             f"{P.get_device()}, not gpu:0")
    rng = np.random.default_rng(0)
    n_ops, n_cmp, worst = _ns_families(P, device, cpu, rng)
    n_inplace = _ns_inplace(P, device, cpu, rng)
    t_a = time.perf_counter() - t0
    # (b) random on the card
    n = 1 << 20
    P.seed(21)
    a = P.rand([n])
    P.seed(21)
    if not torch.equal(a, P.rand([n])):
        raise AssertionError("[namespace] rand does not repeat under seed")
    state = P.get_rng_state()
    b = P.randn([n])
    P.set_rng_state(state)
    if not torch.equal(b, P.randn([n])):
        raise AssertionError("[namespace] randn does not replay its state")
    c = P.randint(-3, 7, [n])
    moments = []
    for tag, v, mu, var in (("rand", a, 0.5, 1 / 12), ("randn", b, 0.0, 1.0),
                            ("randint", c, 1.5, 99 / 12)):
        v = v.double()
        m, s2 = float(v.mean()), float(v.var())
        se = (var / n) ** 0.5
        if abs(m - mu) > 6 * se or abs(s2 - var) > 6 * var * (2 / n) ** 0.5 \
                * 1.5:
            raise AssertionError(f"[namespace] {tag} moments {m}, {s2}")
        moments.append(f"{tag} mean {m:.5f} var {s2:.5f}")
    if a.device != torch.device("cuda", 0) or c.dtype != torch.int64:
        raise AssertionError("[namespace] draws off the card or mistyped")
    del a, b, c
    # (c) save / load of CUDA tensors, bit for bit
    state = {"w": P.randn([256, 128]), "h": P.cast(P.randn([64, 64]),
                                                   "bfloat16"),
             "step": P.arange(1000), "nested": [P.ones([3])]}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.pdparams")
        t1 = time.perf_counter()
        P.save(state, path)
        back = P.load(path)
        t_io = time.perf_counter() - t1
    for k in ("w", "h", "step"):
        if back[k].device != state[k].device or not torch.equal(
                back[k].view(torch.uint8), state[k].view(torch.uint8)):
            raise AssertionError(f"[namespace] {k} did not load back")
    # (d) the user's MLP script, on the card and on the CPU
    mrng = np.random.default_rng(7)
    x = mrng.standard_normal((256, 32)).astype(np.float32)
    y = np.sin(x[:, :1] * 2 + x[:, 1:2]).astype(np.float32)
    init = [mrng.uniform(-0.3, 0.3, (32, 64)).astype(np.float32),
            np.zeros(64, np.float32),
            mrng.uniform(-0.3, 0.3, (64, 1)).astype(np.float32)]
    try:
        card, card_s = _ns_mlp(P, "gpu:0", x, y, init)
        host, host_s = _ns_mlp(P, "cpu", x, y, init)
    finally:
        P.set_device("gpu:0")
    if not card[-1] < 0.5 * card[0]:
        raise AssertionError(f"[namespace] the MLP loss did not fall: "
                             f"{card[0]} -> {card[-1]}")
    bad = [i for i, (u, v) in enumerate(zip(card, host))
           if abs(u - v) > 1e-4 * abs(v)]
    if bad:
        raise AssertionError(f"[namespace] card and CPU losses part at "
                             f"step {bad[0]}: {card[bad[0]]} vs "
                             f"{host[bad[0]]}")
    _no_kernels("namespace", counters)
    log(f"[namespace] (a) {n_ops} ops, {n_cmp} card-vs-CPU comparisons "
        f"(values and fp32 gradients) and {n_inplace} in-place calls "
        f"agree; worst error over the largest value: fp32 "
        f"{worst['float32']:.2e}, bf16 {worst['bfloat16']:.2e}, gradients "
        f"{worst['grad']:.2e} ({t_a:.2f} s); (b) seed and state replay "
        f"exact at 2^20, {'; '.join(moments)}; (c) save + load of 3 CUDA "
        f"tensors bit for bit in {t_io * 1e3:.1f} ms; (d) MLP 50 steps: "
        f"loss {card[0]:.5f} -> {card[-1]:.5f}, card = CPU within "
        f"{max(abs(u - v) / abs(v) for u, v in zip(card, host)):.1e}, "
        f"{card_s * 1e3 / 50:.3f} ms a step on the card ({card_s:.3f} s), "
        f"{host_s * 1e3 / 50:.3f} ms on the CPU; (e) no place -> cuda:0 | "
        f"none of the eleven kernels launched | phase "
        f"{time.perf_counter() - t0:.1f} s | {limit}")
    _empty(device)


# -- phase 20: nn ------------------------------------------------------------

#: GPT-2 small (Radford et al. 2019; the published ``gpt2`` config):
#: layers, width, heads, FFN width, vocabulary, context
GPT2 = dict(layers=12, d=768, heads=12, ffn=3072, vocab=50257, ctx=1024)
#: 20a: batch, sequence, steps, AdamW's learning rate, the dropouts
GPT2_RUN = dict(batch=8, seq=1024, steps=10, lr=6e-4, dropout=0.1,
                attn_dropout=0.1)
#: the PTB "large" LSTM language model (Zaremba, Sutskever & Vinyals
#: 2014): layers, hidden, unrolled steps, batch, vocabulary, dropout,
#: the uniform init range
PTB_LARGE = dict(layers=2, hidden=1500, steps=35, batch=20, vocab=10000,
                 dropout=0.65, init=0.04)
#: 20c: SGD iterations, learning rate and global-norm clip
PTB_RUN = dict(iters=10, lr=1.0, clip=5.0)
#: library attention kernels, by substrings of their names; none may run
#: in 20a's traced step
LIBRARY_ATTENTION = ("fmha", "flash_fwd", "flash_bwd", "pytorch_flash",
                     "efficient_attention", "cudnn", "sdpa")


def _gpt2(P, cfg, dropout, attn_dropout):
    """A user's GPT-2 written against ``paddle.nn`` only: token and
    position embeddings (N(0, 0.02), by ``ParamAttr``), pre-norm blocks
    of a fused q/k/v ``Linear``, ``F.flash_attention(causal=True)``, an
    output projection and a GELU (tanh form) MLP, each branch with
    ``nn.Dropout``; the head tied to the token embedding; the loss
    ``nn.CrossEntropyLoss``.  Everything else at the reference's
    defaults (XavierUniform weights, zero biases)."""
    nn, F = P.nn, P.nn.functional
    d, H, V = cfg["d"], cfg["heads"], cfg["vocab"]

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln_1 = nn.LayerNorm(d)
            self.c_attn = nn.Linear(d, 3 * d)
            self.c_proj = nn.Linear(d, d)
            self.ln_2 = nn.LayerNorm(d)
            self.c_fc = nn.Linear(d, cfg["ffn"])
            self.act = nn.GELU(approximate=True)
            self.mlp_proj = nn.Linear(cfg["ffn"], d)
            self.drop = nn.Dropout(dropout)

        def forward(self, x):
            B, S, _ = x.shape
            qkv = self.c_attn(self.ln_1(x)).reshape([B, S, 3, H, d // H])
            a, _ = F.flash_attention(qkv[:, :, 0], qkv[:, :, 1],
                                     qkv[:, :, 2], dropout=attn_dropout,
                                     causal=True)
            x = x + self.drop(self.c_proj(a.reshape([B, S, d])))
            return x + self.drop(self.mlp_proj(self.act(self.c_fc(
                self.ln_2(x)))))

    class GPT2(nn.Layer):
        def __init__(self):
            super().__init__()
            emb = P.ParamAttr(initializer=nn.initializer.Normal(0.0, 0.02))
            self.wte = nn.Embedding(V, d, weight_attr=emb)
            self.wpe = nn.Embedding(cfg["ctx"], d, weight_attr=emb)
            self.drop = nn.Dropout(dropout)
            self.h = nn.LayerList([Block() for _ in range(cfg["layers"])])
            self.ln_f = nn.LayerNorm(d)
            self.loss = nn.CrossEntropyLoss()

        def forward(self, ids, labels):
            pos = torch.arange(ids.shape[1], device=ids.device)
            x = self.drop(self.wte(ids) + self.wpe(pos))
            for block in self.h:
                x = block(x)
            logits = F.linear(self.ln_f(x), self.wte.weight.t())
            return self.loss(logits.reshape([-1, V]), labels.reshape([-1]))

    return GPT2()


def _gpt2_matmul_params(cfg):
    """N of 6N: the parameters every token multiplies by (the blocks'
    Linear weights and the tied head)."""
    d, f = cfg["d"], cfg["ffn"]
    return cfg["layers"] * (4 * d * d + 2 * d * f) + cfg["vocab"] * d


def _tokens(cfg, B, S, device, seed):
    rng = np.random.RandomState(seed)
    ids = torch.as_tensor(rng.randint(0, cfg["vocab"], (B, S + 1)),
                          device=device)
    return ids[:, :-1], ids[:, 1:]


def phase_nn_gpt(device, limit, cfg=None, run=None):
    """20a: GPT-2 small as a user script, decorate(O2, bf16) + auto_cast,
    AdamW; every attention through ``F.flash_attention(dropout=0.1,
    causal=True)`` on the short-attention kernels (S = 1024, D = 64).
    Returns {kernel: launches over the steps}."""
    import paddle_tpu_torch as P

    cfg = dict(GPT2, **(cfg or {}))
    run = dict(GPT2_RUN, **(run or {}))
    B, S, n, L = run["batch"], run["seq"], run["steps"], cfg["layers"]
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    P.seed(20)
    prev = P.get_device()
    P.set_device("gpu:0" if on_card else "cpu")
    try:
        model = _gpt2(P, cfg, run["dropout"], run["attn_dropout"])
    finally:
        P.set_device(prev)
    n_params = sum(p.numel() for p in model.parameters())
    opt = P.optimizer.AdamW(learning_rate=run["lr"],
                            parameters=model.parameters(), weight_decay=0.1)
    model, opt = P.amp.decorate(models=model, optimizers=opt, level="O2",
                                dtype="bfloat16")
    ids, labels = _tokens(cfg, B, S, device, seed=20)
    counters = _train_counters()
    _zero_counts(counters)
    _reset_peak(device)
    losses, step_ms = [], []
    for _ in range(n):
        t1 = time.perf_counter()
        with P.amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = model(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))         # float() synchronises
        step_ms.append((time.perf_counter() - t1) * 1e3)
    launches = _counts(counters)
    peak = _peak_gib(device)
    want = {k: 0 for k in counters}
    want.update(short_attention_fwd=L * n, short_attention_bwd=L * n)
    if on_card and launches != want:
        raise AssertionError(f"[nn-gpt] launched {launches}, expected "
                             f"{want} (one short-attention forward and "
                             f"backward per layer and step)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[nn-gpt] losses {losses}: not finite or "
                             f"not falling")
    library = []
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with P.amp.auto_cast(level="O2", dtype="bfloat16"):
                loss = model(ids, labels)
            loss.backward()
            opt.clear_grad()
            torch.cuda.synchronize()
        names = {ev.key for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA}
        library = sorted(k for k in names
                         if any(s in k.lower() for s in LIBRARY_ATTENTION))
        ours = sorted(k for k in names if "sattn" in k)
        _zero_counts(counters)
        for k, v in launches.items():    # the traced step does not count
            counters[k].launches = v
        if library or not ours:
            raise AssertionError(f"[nn-gpt] the traced step ran library "
                                 f"attention {library} / short kernels "
                                 f"{ours}")
    ms = float(np.median(step_ms[1:]))
    tokens = B * S
    fpt = 6 * _gpt2_matmul_params(cfg) + 12 * L * cfg["d"] * S
    mfu = fpt * tokens / (ms / 1e3) / BF16_FLOPS
    log(f"[nn-gpt] GPT-2 small as a paddle.nn.Layer script ({L} layers, "
        f"d {cfg['d']}, {cfg['heads']} heads, FFN {cfg['ffn']}, vocab "
        f"{cfg['vocab']}, {n_params / 1e6:.2f} M parameters, tied head), "
        f"decorate(O2, bf16) + auto_cast, AdamW({run['lr']}), dropout "
        f"{run['dropout']} and attention dropout {run['attn_dropout']}, "
        f"B={B} S={S}: first step {step_ms[0]:.1f} ms; step "
        f"{ms:.1f} ms (median of {n - 1}; "
        f"{', '.join(f'{v:.1f}' for v in step_ms[1:])}) | "
        f"{tokens / (ms / 1e3):.0f} tokens/s | MFU {mfu:.4f} (6N + 12LdS = "
        f"{fpt:.4e} flops/token over {BF16_FLOPS / 1e12:g} TFLOP/s bf16) | "
        f"peak memory {peak:.2f} GiB | loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} ({[round(v, 4) for v in losses]}) | launches "
        f"{_launched(counters)} | no library attention in a traced step | "
        f"built in {time.perf_counter() - t0 - sum(step_ms) / 1e3:.1f} s | "
        f"{limit}")
    del model, opt
    _empty(device)
    return launches


def phase_nn_long(device, limit, B=2, H=16, S=2048, D=128):
    """20b: ``F.flash_attn_qkvpacked`` at S = 2048, D = 128, causal, no
    dropout, forward and backward: the long-attention kernels, held
    against their plain versions on the card.  Returns its launches."""
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops.kernels import long_attention as la

    counters = _train_counters()
    gen = torch.Generator(device=device).manual_seed(20)
    qkv = torch.randn(B, S, 3, H, D, generator=gen, device=device).to(
        torch.bfloat16).requires_grad_(True)
    g = torch.randn(B, S, H, D, generator=gen, device=device).to(
        torch.bfloat16)
    _zero_counts(counters)
    out = PF.flash_attn_qkvpacked(qkv, causal=True)
    out.backward(g)
    _sync(device)
    launches = _counts(counters)
    if device.type == "cuda" and not (launches["attention_fwd"] == 1
                                      and launches["attention_bwd"] == 1):
        raise AssertionError(f"[nn-long] launched {launches}")
    q, k, v = (qkv.detach()[:, :, i].transpose(1, 2).contiguous()
               for i in range(3))
    scale = 1.0 / np.sqrt(D)
    wout, wlse = la.attention_fwd_plain(q, k, v, scale, True)
    e_out = _hold("nn-long out", out.detach().transpose(1, 2).contiguous(),
                  wout, 2e-3, 2 ** -7, BF16_WHY)
    wgrads = la.attention_bwd_plain(q, k, v, wout, wlse,
                                    g.transpose(1, 2).contiguous(), scale,
                                    True)
    e_grad = max(_hold(f"nn-long d{n}", qkv.grad[:, :, i].transpose(
        1, 2).contiguous(), w, 5e-3, 2 ** -6,
        "bf16 outputs of sums over up to 4 x 2048 fp32 terms")
        for i, (n, w) in enumerate(zip("qkv", wgrads)))
    del wout, wlse, wgrads, q, k, v

    def fwd_bwd():
        qkv.grad = None
        PF.flash_attn_qkvpacked(qkv, causal=True).backward(g)

    saved = _counts(counters)
    ms = _timed(device, lambda: [fwd_bwd() for _ in range(5)])[1] / 5
    for name, f in counters.items():     # timing does not count
        f.launches = saved[name]
    log(f"[nn-long] F.flash_attn_qkvpacked(qkv [{B}, {S}, 3, {H}, {D}] "
        f"bf16, causal) forward + backward: long_attention launches "
        f"{launches['attention_fwd']} fwd / {launches['attention_bwd']} bwd; "
        f"out max abs err {e_out:.3e}, dq/dk/dv {e_grad:.3e} against the "
        f"plain version | {ms:.3f} ms a forward + backward | {limit}")
    del qkv, g, out
    _empty(device)
    return launches


def _ptb_lstm(P, cfg, dropout):
    """The PTB "large" model as a user writes it with ``paddle.nn``:
    embedding, dropout, a 2-layer LSTM (dropout between layers), dropout,
    the softmax layer, every parameter U(-0.04, 0.04) by ``ParamAttr``;
    the loss ``nn.CrossEntropyLoss``."""
    nn = P.nn
    Hd, V = cfg["hidden"], cfg["vocab"]

    def attr():
        return P.ParamAttr(initializer=nn.initializer.Uniform(
            -cfg["init"], cfg["init"]))

    class PTBModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(V, Hd, weight_attr=attr())
            self.drop = nn.Dropout(dropout)
            self.lstm = nn.LSTM(Hd, Hd, cfg["layers"], dropout=dropout,
                                weight_ih_attr=attr(), weight_hh_attr=attr(),
                                bias_ih_attr=attr(), bias_hh_attr=attr())
            self.out = nn.Linear(Hd, V, weight_attr=attr(), bias_attr=attr())
            self.loss = nn.CrossEntropyLoss()

        def forward(self, x, y, state=None):
            h, state = self.lstm(self.drop(self.embedding(x)), state)
            logits = self.out(self.drop(h))
            return self.loss(logits.reshape([-1, V]), y.reshape([-1])), state

    return PTBModel()


def _ptb_train(P, model, cfg, run, device, seed=0):
    """``run["iters"]`` truncated-BPTT SGD steps over a seeded token
    stream, the state carried (detached) between them: (losses, ms a
    step)."""
    opt = P.optimizer.SGD(learning_rate=run["lr"],
                          parameters=model.parameters(),
                          grad_clip=P.nn.ClipGradByGlobalNorm(run["clip"]))
    B, T = cfg["batch"], cfg["steps"]
    rng = np.random.RandomState(seed)
    stream = torch.as_tensor(rng.randint(
        0, cfg["vocab"], (B, run["iters"] * T + 1)), device=device)
    state, losses, step_ms = None, [], []
    for i in range(run["iters"]):
        x = stream[:, i * T:(i + 1) * T]
        y = stream[:, i * T + 1:(i + 1) * T + 1]
        t1 = time.perf_counter()
        loss, state = model(x, y, state)
        state = tuple(s.detach() for s in state)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t1) * 1e3)
    return losses, step_ms


def phase_nn_lstm(device, limit, cfg=None, run=None):
    """20c: the PTB "large" LSTM language model, 10 SGD steps with
    ``ClipGradByGlobalNorm(5.0)``, fp32."""
    import paddle_tpu_torch as P

    cfg = dict(PTB_LARGE, **(cfg or {}))
    run = dict(PTB_RUN, **(run or {}))
    counters = _train_counters()
    _zero_counts(counters)
    P.seed(21)
    prev = P.get_device()
    P.set_device("gpu:0" if device.type == "cuda" else "cpu")
    try:
        model = _ptb_lstm(P, cfg, cfg["dropout"])
    finally:
        P.set_device(prev)
    _reset_peak(device)
    losses, step_ms = _ptb_train(P, model, cfg, run, device)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[nn-lstm] losses {losses}")
    _no_kernels("nn-lstm", counters)
    ms = float(np.median(step_ms[1:]))
    n = sum(p.numel() for p in model.parameters())
    log(f"[nn-lstm] PTB large LSTM LM ({cfg['layers']} layers, hidden "
        f"{cfg['hidden']}, {cfg['steps']} unrolled steps, batch "
        f"{cfg['batch']}, vocab {cfg['vocab']}, dropout {cfg['dropout']}, "
        f"{n / 1e6:.2f} M parameters, fp32), SGD({run['lr']}) with "
        f"ClipGradByGlobalNorm({run['clip']}): first step "
        f"{step_ms[0]:.1f} ms; step {ms:.1f} ms (median of "
        f"{len(step_ms) - 1}) | {cfg['batch'] * cfg['steps'] / (ms / 1e3):.0f}"
        f" words/s | peak memory {_peak_gib(device):.2f} GiB | losses "
        f"{[round(v, 4) for v in losses]} | none of the eleven kernels "
        f"launched | {limit}")
    del model
    _empty(device)


def _nn_cases(P, rng):
    """20d's cases: {name: (build or None, fn(module, *tensors), numpy
    inputs, differentiable)}.  ``build(P)`` makes the module once on the
    CPU; each device gets a copy."""
    nn, F = P.nn, P.nn.functional

    def r(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    def u(*s):
        return rng.uniform(0.05, 0.95, s).astype(np.float32)

    def ids(hi, *s):
        return rng.integers(0, hi, s).astype(np.int64)

    def fn(name, *args, **kw):
        return lambda m, *t: getattr(F, name)(*t, *args, **kw)

    def call(m, *t):
        return m(*t)

    cases = {
        "linear": (None, fn("linear"), [r(4, 8), r(8, 5), r(5)], True),
        "embedding": (None, fn("embedding", padding_idx=0),
                      [ids(6, 3, 4), r(6, 5)], False),
        "normalize": (None, fn("normalize"), [r(4, 6)], True),
        "mse_loss": (None, fn("mse_loss"), [r(4, 6), r(4, 6)], True),
        "l1_loss": (None, fn("l1_loss"), [r(4, 6), r(4, 6)], True),
        "smooth_l1_loss": (None, fn("smooth_l1_loss"), [r(4, 6), r(4, 6)],
                           True),
        "nll_loss": (None, fn("nll_loss"), [r(5, 4), ids(4, 5)], False),
        "binary_cross_entropy": (None, fn("binary_cross_entropy"),
                                 [u(4, 6), u(4, 6)], True),
        "kl_div": (None, fn("kl_div"), [r(4, 6), u(4, 6)], True),
        "cross_entropy": (None, fn("cross_entropy", label_smoothing=0.1),
                          [r(6, 7), ids(7, 6)], False),
        "dice_loss": (None, fn("dice_loss"), [u(3, 5, 4), ids(4, 3, 5, 1)],
                      False),
        "sigmoid_focal_loss": (None, fn("sigmoid_focal_loss"),
                               [r(4, 3), u(4, 3)], True),
        "multi_margin_loss": (None, fn("multi_margin_loss"),
                              [r(5, 4), ids(4, 5)], False),
        "margin_cross_entropy": (None, fn("margin_cross_entropy",
                                          scale=8.0),
                                 [u(4, 6) * 1.6 - 0.8, ids(6, 4)], False),
        "ctc_loss": (None, fn("ctc_loss"), [r(8, 2, 5), ids(4, 2, 3) + 1,
                                            np.array([8, 6]),
                                            np.array([3, 2])], False),
        "rnnt_loss": (None, fn("rnnt_loss"), [r(2, 5, 4, 6), ids(5, 2, 3) + 1,
                                              np.array([5, 4]),
                                              np.array([3, 2])], False),
        "margin_ranking_loss": (None, fn("margin_ranking_loss"),
                                [r(6), r(6), np.sign(r(6))], True),
        "triplet_margin_loss": (None, fn("triplet_margin_loss"),
                                [r(4, 5), r(4, 5), r(4, 5)], True),
        "cosine_embedding_loss": (None, fn("cosine_embedding_loss"),
                                  [r(4, 5), r(4, 5), np.sign(r(4))], True),
        "poisson_nll_loss": (None, fn("poisson_nll_loss", full=True),
                             [r(6), u(6) * 4], True),
        "gaussian_nll_loss": (None, fn("gaussian_nll_loss"),
                              [r(6), r(6), u(6)], True),
        "npair_loss": (None, fn("npair_loss"), [r(4, 3), r(4, 3),
                                                ids(2, 4)], False),
        "pixel_shuffle": (None, fn("pixel_shuffle", 2), [r(1, 8, 3, 3)],
                          True),
        "grid_sample": (None, fn("grid_sample", align_corners=False),
                        [r(2, 3, 5, 6), r(2, 4, 3, 2, scale=0.8)], True),
        "affine_grid": (None, fn("affine_grid", [2, 3, 4, 5]),
                        [r(2, 2, 3)], True),
        "fold": (None, fn("fold", [4, 5], [2, 2], 2, 1), [r(2, 12, 9)],
                 True),
        "unfold": (None, fn("unfold", [3, 2]), [r(2, 3, 6, 5)], True),
        "bilinear": (None, fn("bilinear"), [r(3, 4), r(3, 5), r(2, 4, 5)],
                     True),
        "local_response_norm": (None, fn("local_response_norm", 3),
                                [r(2, 5, 3, 3)], True),
        "instance_norm": (None, fn("instance_norm"), [r(2, 3, 4, 4)], True),
        "temporal_shift": (None, fn("temporal_shift", 2), [r(4, 8, 2, 2)],
                           True),
        "gather_tree": (None, fn("gather_tree"), [ids(9, 4, 2, 3),
                                                  ids(3, 4, 2, 3)], False),
        "sequence_mask": (None, fn("sequence_mask", 5), [ids(5, 4)], False),
        "flash_attention": (None, lambda m, q, k, v: F.flash_attention(
            q, k, v, causal=True)[0], [r(2, 16, 2, 8), r(2, 16, 2, 8),
                                       r(2, 16, 2, 8)], True),
        "sparse_mask attention": (
            None, lambda m, q, k, v, s: F.flash_attention_with_sparse_mask(
                q, k, v, attn_mask_start_row_indices=s, is_causal=False),
            [r(2, 16, 2, 8), r(2, 16, 2, 8), r(2, 16, 2, 8),
             ids(16, 2, 16)], True),
        "fused_rotary_position_embedding": (
            None, lambda m, q, k, c, s: F.fused_rotary_position_embedding(
                q, k, sin=s, cos=c)[:2],
            [r(2, 16, 2, 8), r(2, 16, 2, 8), np.cos(r(16, 8)),
             np.sin(r(16, 8))], True),
    }
    layers = {
        "Linear": (lambda: nn.Linear(6, 4), [r(3, 6)]),
        "Conv2D": (lambda: nn.Conv2D(3, 4, 3, 1, 1), [r(2, 3, 5, 5)]),
        "LayerNorm": (lambda: nn.LayerNorm([4, 6]), [r(3, 4, 6)]),
        "BatchNorm1D": (lambda: nn.BatchNorm1D(4), [r(5, 4)]),
        "InstanceNorm1D": (lambda: nn.InstanceNorm1D(3), [r(2, 3, 7)]),
        "LocalResponseNorm": (lambda: nn.LocalResponseNorm(3),
                              [r(2, 5, 2, 2)]),
        "PReLU": (lambda: nn.PReLU(3), [r(2, 3, 4)]),
        "Bilinear": (lambda: nn.Bilinear(3, 4, 2), [r(5, 3), r(5, 4)]),
        "GLU": (lambda: nn.GLU(), [r(3, 8)]),
        "Pad2D reflect": (lambda: nn.Pad2D([1, 2, 1, 0], "reflect"),
                          [r(1, 2, 4, 5)]),
        "Unflatten": (lambda: nn.Unflatten(1, [2, 3]), [r(2, 6)]),
        "Maxout": (lambda: nn.Maxout(2), [r(2, 4, 3)]),
        "Softmax2D": (lambda: nn.Softmax2D(), [r(2, 3, 2, 2)]),
        "SpectralNorm": (lambda: nn.SpectralNorm([6, 4]), [r(6, 4)]),
        "PixelUnshuffle": (lambda: nn.PixelUnshuffle(2), [r(1, 2, 4, 4)]),
        "CosineSimilarity": (lambda: nn.CosineSimilarity(), [r(4, 3),
                                                             r(4, 3)]),
        "SimpleRNN": (lambda: nn.SimpleRNN(5, 6, 2, direction="bidirect"),
                      [r(3, 4, 5)]),
        "LSTM": (lambda: nn.LSTM(5, 6, 2), [r(3, 4, 5)]),
        "GRU": (lambda: nn.GRU(5, 6, time_major=True), [r(4, 3, 5)]),
        "LSTMCell": (lambda: nn.LSTMCell(5, 6), [r(3, 5)]),
        "MultiHeadAttention": (lambda: nn.MultiHeadAttention(8, 2),
                               [r(2, 5, 8)]),
        "TransformerEncoderLayer": (
            lambda: nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0),
            [r(2, 5, 8)]),
        "HSigmoidLoss": (lambda: nn.HSigmoidLoss(6, 7), [r(4, 6),
                                                         ids(7, 4)]),
        "AdaptiveLogSoftmaxWithLoss": (
            lambda: nn.AdaptiveLogSoftmaxWithLoss(8, 12, [4, 8]),
            [r(6, 8), ids(12, 6)]),
    }
    for act in ("CELU", "ELU", "Hardshrink", "Hardtanh", "LeakyReLU",
                "LogSigmoid", "LogSoftmax", "Mish", "SELU", "Sigmoid",
                "Softplus", "Softshrink", "Softsign", "Tanh", "Tanhshrink",
                "ThresholdedReLU"):
        layers[act] = (lambda act=act: getattr(nn, act)(), [r(3, 5,
                                                              scale=2.0)])
    for name, (build, arrays) in layers.items():
        cases[name] = (build, call, arrays, True)
    return cases


def _nn_leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _nn_leaves(o)]
    return []


def _nn_run(mod, fn, arrays, grad, device):
    """(output leaves, gradients of a fixed weighted sum of them with
    respect to the float inputs and the parameters) on ``device``."""
    ts = [torch.as_tensor(a, device=device) for a in arrays]
    ins = [t.requires_grad_(grad) for t in ts if t.is_floating_point()]
    params = [] if mod is None else [p for p in mod.parameters()
                                     if p.requires_grad]
    leaves = _nn_leaves(fn(mod, *ts))
    grads = []
    if grad:
        total = sum((x * torch.cos(torch.arange(
            x.numel(), device=device, dtype=x.dtype)).reshape(x.shape)).sum()
            for x in leaves if x.is_floating_point())
        grads = torch.autograd.grad(total, ins + params, allow_unused=True)
    return ([x.detach().cpu() for x in leaves],
            [None if g is None else g.detach().cpu() for g in grads])


def _nn_parity_families(P, device, rng):
    """20d(i): every case of ``_nn_cases`` on the card and on the CPU:
    values and fp32 gradients within 1e-5 of the largest magnitude (at
    least 1), the CPU tests' tolerance.  Returns (cases, worst)."""
    import copy

    cpu = torch.device("cpu")
    worst = 0.0
    cases = _nn_cases(P, rng)
    for name, (build, fn, arrays, grad) in cases.items():
        mod = None
        if build is not None:
            P.seed(0)
            mod = build()
            mod.eval()
        outs = {}
        for dev in (device, cpu):
            m = None if mod is None else copy.deepcopy(mod).to(dev)
            outs[dev.type] = _nn_run(m, fn, arrays, grad, dev)
        (got, ggot), (want, gwant) = outs[device.type], outs["cpu"]
        for kind, a, b in [("value", x, y) for x, y in zip(got, want)] + [
                ("grad", x, y) for x, y in zip(ggot, gwant)
                if x is not None]:
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"[nn-parity] {name} {kind}: {a.dtype} "
                                     f"{tuple(a.shape)} vs {b.dtype} "
                                     f"{tuple(b.shape)}")
            if not a.is_floating_point():
                if not torch.equal(a, b):
                    raise AssertionError(f"[nn-parity] {name} {kind} differ")
                continue
            scale = max(1.0, float(b.abs().max()) if b.numel() else 1.0)
            err = float((a.double() - b.double()).abs().max()) / scale \
                if b.numel() else 0.0
            worst = max(worst, err)
            if not err <= 1e-5:
                raise AssertionError(f"[nn-parity] {name} {kind}: error "
                                     f"{err:.3e} of the largest value")
    return len(cases), worst


def _nn_parity_models(P, device):
    """20d(ii): a 2-layer narrow GPT (fp32, AdamW) and the PTB LSTM at
    hidden 64 (fp32, SGD + clip), the same weights on the card and on the
    CPU, 3 steps each: losses within 1e-4.  ``nn.Dropout`` and the
    attention dropout are 0 here: on the CPU the attention takes the
    einsum route, whose dropout mask is not the kernel's hash mask."""
    import copy

    cpu = torch.device("cpu")
    counters = _train_counters()
    gcfg = dict(GPT2, layers=2, d=128, heads=2, ffn=512, vocab=512,
                ctx=256)
    lcfg = dict(PTB_LARGE, hidden=64, vocab=500, batch=4)
    P.seed(22)
    prev = P.get_device()
    P.set_device("cpu")
    try:
        gpt = _gpt2(P, gcfg, 0.0, 0.0)
        lstm = _ptb_lstm(P, lcfg, 0.0)
    finally:
        P.set_device(prev)
    out = {}
    for dev in (device, cpu):
        g = copy.deepcopy(gpt).to(dev)
        opt = P.optimizer.AdamW(learning_rate=1e-3, parameters=g.parameters())
        ids, labels = _tokens(gcfg, 2, 256, dev, seed=22)
        before = _counts(counters)
        losses = []
        for _ in range(3):
            loss = g(ids, labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        launched = {k: v - before[k] for k, v in _counts(counters).items()}
        if dev.type == "cuda" and not (
                launched["short_attention_fwd"]
                == launched["short_attention_bwd"] == 3 * gcfg["layers"]):
            raise AssertionError(f"[nn-parity] the card's GPT did not take "
                                 f"the short kernel: {launched}")
        lm = copy.deepcopy(lstm).to(dev)
        llosses, _ = _ptb_train(P, lm, lcfg, dict(PTB_RUN, iters=3), dev,
                                seed=22)
        out[dev.type] = (losses, llosses)
    rel = []
    for got, want in zip(out[device.type], out["cpu"]):
        got, want = np.array(got), np.array(want)
        rel.append(float(np.max(np.abs(got - want) / np.abs(want))))
    if not max(rel) <= 1e-4:
        raise AssertionError(f"[nn-parity] losses differ: {out}")
    return out, rel


def phase_nn_parity(device, limit):
    """20d: card = CPU for the new layers and functional ops and for a
    narrow GPT and LSTM carried across."""
    import paddle_tpu_torch as P

    t0 = time.perf_counter()
    rng = np.random.default_rng(20)
    prev = P.get_device()
    P.set_device("cpu")
    try:
        n_cases, worst = _nn_parity_families(P, device, rng)
    finally:
        P.set_device(prev)
    t_a = time.perf_counter() - t0
    out, rel = _nn_parity_models(P, device)
    log(f"[nn-parity] (i) {n_cases} layers and functional ops, card vs "
        f"CPU from the same seeded inputs and weights: values and fp32 "
        f"gradients agree, worst error {worst:.2e} of the largest value "
        f"(limit 1e-5) ({t_a:.2f} s); (ii) 2-layer GPT (d 128, S 256, the "
        f"short kernel on the card) losses {out[device.type][0]} vs CPU "
        f"{out['cpu'][0]}, PTB LSTM (hidden 64) losses "
        f"{out[device.type][1]} vs CPU {out['cpu'][1]}: max relative "
        f"difference {max(rel):.2e} (limit 1e-4; dropout 0) | phase "
        f"{time.perf_counter() - t0:.1f} s | {limit}")
    _empty(device)


def phase_nn(device, limit):
    """20 (module docstring): ``paddle.nn`` as a user drives it.  Returns
    {kernel: launches} of 20a and 20b together."""
    t0 = time.perf_counter()
    gpt = phase_nn_gpt(device, limit)
    t_a = time.perf_counter()
    long = phase_nn_long(device, limit)
    t_b = time.perf_counter()
    phase_nn_lstm(device, limit)
    t_c = time.perf_counter()
    phase_nn_parity(device, limit)
    log(f"[nn] legs: 20a {t_a - t0:.1f} s, 20b {t_b - t_a:.1f} s, 20c "
        f"{t_c - t_b:.1f} s, 20d {time.perf_counter() - t_c:.1f} s")
    return {k: gpt[k] + long[k] for k in gpt}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401  (fails outside the repo)
    from paddle_tpu_torch.models import LlamaConfig

    t0 = time.perf_counter()
    device = torch.device("cuda", 0)

    def elapsed(what):
        log(f"[time] {what} done at {time.perf_counter() - t0:.1f} s")

    name, limit = phase_device()
    # 15c runs on the card while nvcc builds the kernels on the host (the
    # UNet's step launches none of them, and 15c gates that)
    built = {}

    def build():
        try:
            phase_build()
        except BaseException as e:   # re-raised below, after 15c
            built["error"] = e

    builder = threading.Thread(target=build, name="build")
    builder.start()
    log("[unet-train-64] runs while nvcc builds the kernels on the host")
    phase_unet_train(device, limit, run=UNET_64_RUN, tag="unet-train-64",
                     unet_kw=dict(sample_size=64))
    _empty(device)
    elapsed("phase 15c")
    builder.join()
    if "error" in built:
        raise built["error"]
    elapsed("build")
    rows = [phase_kernels(device)]
    train_rows = phase_train_kernels(device)
    quant_rows = phase_quant_kernels(device)
    phase_verify_kernels(device)
    short_rows = phase_short_kernels(device)
    grouped_rows = phase_grouped_kernels(device)
    elapsed("kernel checks")
    launches, streams = phase_serve_ab(device)
    rows[0]["launches"] = launches["paged_decode"]
    elapsed("phase 4")
    phase_aot(device, streams)
    elapsed("phase 4e")
    launches, _ = phase_serve_ab(device, quant="int8")
    for row in quant_rows:
        row["launches"] = launches[row["name"]]
    elapsed("phase 4c")
    # the serving kernels' launches under serve.verify replays (4f)
    verify = phase_features(device, streams, profile=False)
    for row in [rows[0]] + quant_rows:
        row["verify_launches"] = verify[row["name"]]
    elapsed("phase 4f")
    phase_parity(device)
    phase_parity(device, quant="int8")
    elapsed("phase 5")
    phase_parity_features(device)
    elapsed("serving")
    durable, setup = phase_durable(device)
    for row in [rows[0]] + quant_rows:
        row["durable_launches"] = durable[row["name"]]
    elapsed("phase 4g")
    elastic = phase_elastic(device, setup)
    for row in [rows[0]] + quant_rows:
        row["elastic_launches"] = elastic[row["name"]]
    del setup
    _empty(device)
    elapsed("phase 4h")
    decode13 = phase_decode_13b(device)
    for row in [rows[0]] + quant_rows:
        row["decode_13b_launches"] = decode13[row["name"]]
    elapsed("phase 4i")
    phase_parity_durable(device)
    elapsed("phase 5c")
    phase_parity_elastic(device)
    elapsed("durable serving")
    phase_parity_decoding(device)
    elapsed("phase 5e")
    launches, step, batch = phase_train(device, limit)
    for row in train_rows:
        if not launches[row["name"]]:
            raise AssertionError(f"[train] {row['name']} never launched")
    rows += train_rows + quant_rows
    phase_train_profile(step, batch, device)
    del step, batch
    torch.cuda.empty_cache()
    elapsed("phase 6")
    phase_train(device, limit, tag="train-s4096",
                cfg=LlamaConfig.llama2_7b(num_hidden_layers=4,
                                          recompute=True,
                                          recompute_policy="full",
                                          attention_impl="auto"),
                run=dict(batch=2, seq=4096, steps=3))
    torch.cuda.empty_cache()
    elapsed("phase 6d")
    phase_train(device, limit, tag="train-s512",
                cfg=LlamaConfig.llama2_7b(num_hidden_layers=2,
                                          recompute=True),
                run=dict(batch=4, seq=512, steps=2))
    torch.cuda.empty_cache()
    phase_train_parity(device)
    torch.cuda.empty_cache()
    elapsed("phases 6c, 7")
    # the full-depth train step is this slice's main training path: the
    # training rows count its eager steps where each kernel launches,
    # and show beside that the tally its replayed graph added
    launches, replayed = phase_train_full(device, limit)
    for row in train_rows:
        row["launches"] = launches[row["name"]]
        row["replay_launches"] = replayed[row["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    elapsed("phase 6e")
    phase_graph_ab(device, limit)
    elapsed("phase 6f (fp32 master)")
    phase_graph_ab(device, limit, master="bfloat16_sr")
    elapsed("phase 6f")
    phase_remat_policies(device, limit)
    elapsed("phase 6g")
    phase_guarded(device, limit)
    elapsed("phase 6h")
    durable_train = phase_durable_train(device, limit)
    for row in train_rows:
        row["durable_launches"] = durable_train[row["name"]]
    elapsed("llama training")
    launches, step, batch = phase_bert_train(device, limit)
    for row in short_rows:
        row["launches"] = launches[row["name"]]
    rows += short_rows
    phase_bert_profile(step, batch)
    del step, batch
    torch.cuda.empty_cache()
    elapsed("phases 8, 8b")
    phase_bert_graph(device, limit)
    elapsed("phase 8c")
    phase_bert_parity(device)
    elapsed("bert")
    launches, step, batch = phase_moe_train(device, limit)
    grouped_rows[0]["launches"] = launches["grouped_ffn"]
    phase_moe_profile(step, batch)
    del step, batch
    torch.cuda.empty_cache()
    grouped_rows[1]["launches"] = phase_moe_int8(device, limit)
    torch.cuda.empty_cache()
    phase_moe_parity(device)
    rows += grouped_rows
    elapsed("moe")
    resnet = phase_resnet_train(device, limit)
    elapsed("phase 12")
    phase_resnet_graph(device, limit)
    elapsed("phase 12c")
    phase_detection_train(device, limit)
    elapsed("phase 13")
    phase_vision_parity(device)
    elapsed("vision")
    _, step, batch = phase_unet_train(device, limit)
    elapsed("phase 15")
    phase_unet_profile(step, batch, device, limit)
    del step, batch
    _empty(device)
    elapsed("phase 15b")
    phase_unet_parity(device)
    elapsed("unet")
    phase_eager_resnet(device, limit, graph_ms=min(
        r["graph_ms"] for r in resnet.values()))
    elapsed("phase 17")
    phase_eager_detection(device, limit)
    elapsed("phase 17b")
    phase_eager_parity(device)
    elapsed("phase 17c")
    phase_zoo(device, limit)
    elapsed("eager loop and zoo")
    phase_detection_eval(device, limit)
    phase_detection_ops(device, limit)
    elapsed("phase 18")
    phase_namespace(device, limit)
    elapsed("phase 19")
    nn_launches = phase_nn(device, limit)
    for row in rows:
        if row["name"] in ("attention_fwd", "attention_bwd",
                           "short_attention_fwd", "short_attention_bwd"):
            row["nn_launches"] = nn_launches[row["name"]]
    elapsed("phase 20")
    log(f"[done] all phases in {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + ("replay_launches", "verify_launches",
                                  "durable_launches", "elastic_launches",
                                  "decode_13b_launches", "nn_launches")
         if k in r}
        for r in rows]}))
    print(limit)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
