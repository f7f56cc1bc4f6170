#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--parent DIR]

Builds the port's CUDA kernels and native runtime from the sources in the
checkout, then, on the card:

1. device and build: the card's name and power limit, build seconds;
2. each paged kernel against its plain PyTorch version in bf16, at the
   flagship shapes (decode also at head_dim 128; prefill at three chunk
   offsets); then, from a seventh generator (seed + 6), both in fp32 over
   float, int8 and int4 pools at D=64 and over MLA's latent pages at
   D=288 (bf16 pools: phases 9 (b) and 12 (a)), and the bf16 and fp32
   decode twice on the same inputs, equal bit for bit (its KV axis is
   split across CTAs and the splits merge in a fixed order);
3. the flash forward, dQ and dK/dV kernels against their plain versions
   at the train shapes (B=4, Hq=16, Hkv=4, S=2048, D=64, causal) in bf16
   and fp32, and at small shapes over the rest of the mask zoo, bias,
   interleaved GQA, head dims 128 and 256, and ragged rectangular S;
4. full-width serving logits: the flagship model (random weights from the
   seed) through ``prefill_chunk`` and ``decode_step``, against the plain
   fp32 ``forward`` (``attn_fn=plain_attention``, no kernel) on fp32
   copies of the same weights;
5. the serving path: a ``ServingEngine`` with its defaults serves 8
   requests, with the paged kernels' launch counts set to 0 just before
   and read after;
6. full-width fp32 gradients: one ``loss_fn`` gradient at B=2, S=1024 on
   fp32 copies of the flagship weights, through the flash kernels against
   the same call with ``attn_fn=plain_attention``;
7. the training path: ``make_train_step`` trains the bf16 flagship with
   Adam for 8 steps on one seeded batch of 4 × 2049 tokens, with the flash
   kernels' launch counts set to 0 just before and read after; then the
   same 8 steps twice more from the same initial parameters, the two runs
   equal bit for bit after every step (parameters and gradients) and their
   final parameters equal to the first run's;
8. kernel, plain-version and library (SDPA) times at the engine's and the
   train step's shapes (the paged decode's time covers both of its
   launches, the split kernel and the merge; the paged kernels' and SDPA's
   device time by the profiler beside their events, and at D=64 the
   decode's by kernel);
9. the quantized serving slice (inputs from a second generator, seed + 1,
   so the phases above see the same numbers as before it was added):
   (a) the dynamic W8A8/W4A8 GEMM kernel against its plain version, bit
   for bit, at the flagship's and MLAConfig()'s projection shapes; (b) the paged kernels'
   int8 and int4 pool modes against their plain versions in bf16; (c)
   full-width logits of ``quantize_weights`` params (W8A8 over an int8
   pool, W4A8 over an int4 pool) through ``prefill_chunk`` and
   ``decode_step`` against the fp32 ``forward`` on the dequantized weights
   (``attn_fn=plain_attention``, no kernel), gated on the weights after
   phase 7's train steps and reported without a gate, before phase 7, on
   the random-init weights; (d) a ``ServingEngine`` with
   W8A8 weights and an int8 pool, and one with W4A8 weights and an int4
   pool, each serving the 8 requests with the launch counts set to 0 just
   before and read after; (e) times of the GEMM summed over one model
   call's projections and of the paged kernels' quantized modes, beside
   their bounds, plain versions and library calls;
10. the quantized-attention slice (inputs from a third generator, seed +
   2): (a) the quantized forward kernel against its plain version in bf16,
   at the flagship's attention shapes (B=2, Hq=16, Hkv=4, S=2048, D=64,
   causal) in the unpacked model's mode (int8 Q, ROW K/V), dequant-on-load
   ROW CENTERED int8 and int4 and folded TENSOR and ROW scales, and at
   small shapes over int8 P·V with CHANNEL/TENSOR V, BLOCK_2D, bias, a
   sliding window, interleaved GQA, D=128, ragged S and D=80 / 96 (run
   zero-padded at 128; at D=96 also BLOCK_2D with 48-wide blocks, which
   do not tile 128); (b) the head-pair
   kernel against its plain version at the flagship shapes in the packed
   layout, int8 and int4, causal and full; (c) both runtime quantization
   kernels against their plain versions, bit for bit, each called twice
   with the same bits, in every strategy at 8 and 4 bits in bf16 and
   fp32, at the facade's rows, at [4096, 1024] with bs 64 and 128 and at
   ragged, unaligned and small shapes (RTQ_ROW_SHAPES, RTQ_BLOCK_SHAPES);
   (d) full-width
   ``quantized_forward(quantize_weights(params), tokens, cfg,
   quantize_kv=True)`` on 2 x 2048 tokens, packed (auto) and unpacked,
   against the fp32 ``forward`` on the dequantized weights, gated on the
   weights after phase 7's train steps and reported without a gate, before
   phase 7, on the random-init weights, with 8 head-pair (packed) or 8
   quantized-forward (unpacked) and 57 GEMM launches per call; (e)
   ``QuantizedAttention`` (int8 CENTERED, and int4 with the Hadamard
   rotation, causal) at the flagship attention shapes against the dense
   fp32 attention, with 2 row-kernel and 1 quantized-forward launches per
   call, and ``runtime_quantize`` with the blockwise-centered
   configuration, the block kernel's entry point; (f) times of the four
   kernels beside their bounds, plain versions and library calls (the
   two quantizers also by the profiler's device time, the block kernel at
   bs 64 and 128), and of one int8 CENTERED ``QuantizedAttention`` call
   by events and device time by kernel;
11. the quantized backward (inputs from a fourth generator, seed + 3): (a)
   the full-integer dQ and dK/dV kernels against their plain versions at
   the JAX package's north-star shape (bench.py: B=4, H=4, S=4096, D=256,
   FULL), levels 1 and 2, ROW and TENSOR K; the exact quantized dQ and
   dK/dV kernels at the flagship's attention shapes in folded ROW /
   CHANNEL / TENSOR and dequant ROW CENTERED int8 / int4 modes, and at
   small shapes over BLOCK_2D, bias with dbias, a sliding window,
   interleaved GQA, D=128 / 256, ragged S and D=80 / 96 (zero-padded at
   128, at D=96 also BLOCK_2D with 48-wide blocks; the full-integer pair
   too, level 1), and the full-integer pair at level 2 over 8-wide spans
   (S=200), the width its scalar kernels take; (b) bench.py's loss,
   sum(O·dO) through ``quantized_flash_attention(quantize_q=True,
   bwd_fullint=True | False)`` at the north-star shape, differentiated with
   respect to (q, K scales, V scales) with one full-integer (or exact) dQ
   and dK/dV launch each, the full-integer gradients against the exact
   ones and the exact ones against the fp32 dense VJP on the dequantized
   K/V (rel L2 ≤ 0.05 each); (c) ``quantized_flash_attention_qat`` and the
   ``QuantizedAttention`` gradient with respect to q at the flagship's
   attention shapes against the dense VJP (< 0.05); (d) on (b)'s own
   inputs, the kernels it launched against their plain versions in the
   modes it launched them (the quantized forward with int8 Q and P at
   D=256, both full-integer and both exact kernels), then the four
   backward kernels' and that forward's times beside their bounds, plain
   versions and SDPA, the full-integer pair at level 2 too (512-key and
   1024-query spans);
12. MLA serving and the weight-only GEMM (inputs from a fifth generator,
   seed + 4): (a) both paged kernels at MLA's geometry (Hq=16 over Hkv=1,
   D=288, one-state latent pages, v_tail_zero=32) with bf16 and int8
   pools against their plain versions; (b) the flash forward, dQ and
   dK/dV kernels at D=80 and 288 (the bf16 forward at 288 on
   ``flash_fwd_wide_kernel``, also in its static-max mode at B=2, S=2048
   with "estimate" and a caller's bound; the bf16 dQ and dK/dV at 288 on
   their tensor-core wide bodies; the forward in both modes, the dQ and
   the dK/dV each called twice at B=2, S=2048 and equal bit for bit);
   (c) the quantized forward's int8 P over the TPU's block_kv spans
   (NORTH_STAR_BLOCKS' and 128) at the north-star shape against
   ``qattn_fwd_plain(kv_tile=block_kv)``; (d)
   both weight-only GEMM kernels against their plain versions at the
   decompression shape (M=4096, N=1024, K=256): folded int8 / int4 ROW and
   int8 TENSOR, dequant-on-load BLOCK 128, ASYMMETRIC ROW and an fp32 A,
   each with and without ``c=``, in fp32, and their bf16 results equal to
   the fp32 ones rounded; (e) ``mla_decompress`` over quantized
   W_uk / W_uv (int8 ROW, int8 BLOCK 128) then ``flash_attention`` at B=2,
   S=2048 against ``mla_absorbed_attention`` on the dequantized weights
   (rel L2 ≤ 0.05), 2 GEMM launches per call, the path's time, and
   ``mla_absorbed_attention`` over a per-token int8 latent at B=2, S=2048
   (the quantized forward at Hq=16 over Hkv=1, D=256) with its one launch
   held to the plain version on the same arguments; (f) full-width
   ``MLAConfig()`` serving logits (random weights from the seed) through
   ``mla_prefill_chunk`` and ``mla_decode_step`` against the fp32
   ``mla_forward`` with the dense decompress-then-attend attention (no
   kernel): float latent pool (rel L2 ≤ 0.05) and ``quantize_mla_weights``
   over an int8 latent pool, on the dequantized weights (≤ 0.25); (g)
   ``ServingEngine(..., executor=mla_executor())`` serving the 8 requests,
   float and W8A8 + int8 latent, the launch counts set to 0 just before
   and read after; (h) times of the paged kernels at MLA's geometry (the
   decode's split kernel and merge together; the prefill on the tensor
   cores over the 256 kept lanes), the flash kernels at D=288 (the body
   each runs, the device ms of each launch; with ``--parent`` in turns)
   and ``flash_dkv_merge_kernel`` alone on the MLA train shape's
   workspace (bit for bit with its plain version), and both GEMM kernels
   beside their bounds, plain versions and library calls;
13. the GEMM engine (inputs from a sixth generator, seed + 5): (a) the
   quantized-A kernels (folded int8 / int4 ROW and int8 TENSOR; dequant
   ROW ASYMMETRIC, BLOCK 128 and an fp32 B) and the compensated ones
   (BLOCK 128 and 512 with asymmetric zero points, bit for bit; small
   blocks 32 and 64; each with and without ``c=``) against their plain
   versions at the flagship's projection shapes (M=4096) and
   benchmarks/gemm_bench.py's (M=128 and 4096, N=K=8192); (b)
   ``ops.gemm.matmul`` at M=4096, N=K=1024 over every operand kind and
   dispatch arm (the degraded QT × QT arms: int4 A, unequal blocks, ROW
   B, no fast int8 path; ``transpose_a``; ``c=``) against the dequantized
   reference, with exactly one launch of the expected GEMM kernel per
   call; (c) the four kernels' times at gemm_bench's shapes, on
   utils/profiling.py's arms, beside their bounds, plain versions and
   library calls, and both weight-only kernels' there (gemm_bench's
   weight-only int8 / int4 BLOCK 256 arms through ``wo_gemm``, int8 ROW
   SYMMETRIC through ``wo_folded_gemm``), first held to their plain
   versions in fp32 and their bf16 results to the fp32 ones rounded;
14. the dispatch layer (inputs from an eighth generator, seed + 7; the
   calibration store is a fresh temporary directory, ``MFA_CACHE_DIR``,
   set before phase 1): (a) ``MultiHeadAttention`` at the path's shape
   (the train step's B=4, Hq=16, Hkv=4, S=2048, D=64, causal, bf16) and
   at small shapes (grouped and interleaved GQA, MQA, a sliding window):
   ``forward`` launches 1 flash forward, ``__call__`` with
   ``torch.autograd.grad`` 1 forward + 1 dQ + 1 dK/dV, ``backward`` 1 dQ
   + 1 dK/dV (the counts set to 0 just before and read after), each equal
   bit for bit to the direct ``flash_attention_forward`` /
   ``flash_attention`` / ``flash_attention_backward`` call; (b) the flash
   forward's static-max mode (``row_max``) against its plain version on
   the same subtrahends, bf16 at the path's shape and at D=128, 256 and
   288 (``flash_fwd_wide_kernel``), fp32 at D=64, over FULL, CAUSAL, a
   window and sparse ranges, with "estimate" and a caller's bound (the
   true row max + 5), at the flash gates, O's gap to the running-max
   kernel logged; ``flash_attention_forward(row_max="estimate")`` at the
   path's shape with its one launch; (c)
   ``AttentionTuner.calibrate_gemm`` into the run's store: the dynamic
   GEMM at the flagship projections' (N, K) for M = 8, 256 and 4096, the
   weight-only GEMM at gemm_bench's (128, 8192,
   8192), the chosen plan against the cold start with both device times,
   ``recommend_gemm`` giving it back, and the GEMM launched under it held
   to its plain version (the dynamic one bit for bit); (d)
   ``QuantizedAttention().benchmark()`` at its defaults; (e) device and
   event times of the static-max kernel, the running-max kernel and SDPA
   at the path's shape, beside the bound and the static-max plain version
   (the running-max kernel in ``--parent`` turns);
15. MLA training (inputs from a ninth generator, seed + 8): (a) fp32
   copies of ``MLAConfig()``'s weights at B=1, S=1024: every parameter's
   gradient of ``mla_loss_fn`` through the flash kernels at D = d_c + d_r
   = 288 against ``attn_fn=plain_mla_attention`` (no kernel), rel L2 ≤
   GRAD_REL_L2_TOL; (b) the bf16 model trained with Adam
   (``make_train_step(..., loss=mla_loss_fn)``) for 8 steps on
   one seeded batch of 2 x 2049 tokens, the flash counts set to 0 just
   before and read after every step: exactly 8 forwards, 8 dQ and 8 dK/dV
   a step (and 8 merges of the split dK/dV where ``dkv_splits`` splits),
   the loss falls, ms a step and tokens/s, the host's span of each step's
   call; 3 more steps under the profiler: the device's busy time a step
   and its idle share; with ``--parent`` the step timed on the parent's
   kernels and this checkout's in turns; (c) the
   same 8 steps twice more from the initial parameters, equal bit for bit
   after every step and at the end equal to (b)'s; (d) 3 steps,
   ``save_checkpoint`` (parameters and ``optimizer.state_dict()``;
   ``force=False`` refuses to overwrite), 2 more, against
   ``load_checkpoint`` into fresh parameters and a fresh optimizer and the
   same 2 steps: equal bit for bit;
16. context parallelism (inputs from a tenth generator, seed + 9): a world
   of 4 gloo ranks, each a process on cuda:0 (``mp.spawn``; the kernels
   built before; a FileStore rendezvous; the context group of
   ``make_mesh(1, 1, 4)``), each holding its share of the global inputs:
   (a) ``ring_attention`` causal and FULL at B=1, Hq=16, Hkv=4, D=64,
   S = 4 x 2048, bf16, O and the gradients of sum(O · dO) gathered to rank
   0 against the single-device ``flash_attention`` on the same global
   inputs at phase 3's bf16 gates, each rank launching exactly its
   non-empty steps (rank i: i + 1 causal, 4 FULL, in each direction), a
   rerun equal bit for bit; (b) ``ring_attention_zigzag`` against (a)'s
   causal reference, 9 launches a direction on every rank, the pre/post
   shard round trip exact; (c) ``ulysses_attention``, one launch a
   direction; (d) the MLA latent ring (W_uk absorbed per rank, the
   head-shared latent through the ring) at H=16, dh=64, d_c=256, S = 4 x
   2048 against the single-device ``mla_absorbed_attention``; (e) fp32 at
   Hq=4, Hkv=2, S = 4 x 256, D=64 (ring causal, FULL and interleaved,
   zigzag, Ulysses) at the fp32 flash gate.  The ranks time-share one
   card, so the phase reports gates, launches and wall seconds, no speed;
17. long context and the utilities (inputs from an eleventh generator,
   seed + 10): (a) ``mla_absorbed_attention`` at B=1, H=8, S=32768, dh=64,
   d_c=256 over an int8 ROW latent with a causal window of 4096 (the
   construction of tests/test_long_context.py:112): one quantized-forward
   launch, a finite output; the kernel against its plain version at
   S=8192 with the same mask; (b) ``save_quantized`` then
   ``load_quantized`` of CUDA tensors (int8 ROW, int4 BLOCK 64 with sums):
   loaded onto the card by default, equal bit for bit; (c) ``dump_lowered``
   of ``flash_attention_forward`` on card inputs: the file holds the
   traced graph and the SASS of ``flash_fwd_tc_kernel``;
18. the 3D-parallel train step, expert and pipeline parallelism (inputs
   from a twelfth generator, seed + 11): a world of 4 gloo ranks on
   cuda:0 as phase 16's (``mp.spawn``, a FileStore, the kernels built
   before), the flagship on ``make_mesh(1, 2, 2)`` with ring attention
   (``parallel/spmd.py``): (a) fp32 at B=1, S=1024, the loss and every
   gradient of ``make_spmd_loss_and_grad`` gathered to rank 0 against the
   single-device ``loss_fn`` on the card (rel L2 ≤ GRAD_REL_L2_TOL), the
   replicas' gradients equal bit for bit; (b) the bf16 flagship, 3
   ``make_spmd_train_step`` steps with AdamW on phase 7's 4 x 2049
   tokens, against the single-device ``make_train_step`` with the same
   AdamW from the same parameters: step 0's loss within 2e-2 of its
   loss, every step's within SPMD_TRAIN_LOSS_TOL, the parameters' update
   over the 3 steps (the final shards gathered) within SPMD_UPDATE_TOL
   rel L2 of its, the losses the same on every rank, finite and falling,
   the flash counts set to 0 just
   before each step and read after it (exactly 8 forwards, 8 dQ and 8
   dK/dV a step at context position 0, 16 at 1), the 3 steps rerun from
   the same shards equal bit for bit (else, reported, equal losses across
   the model ranks), the wall seconds a step (not a speed: the ranks
   time-share the card); (c) fp32 at the CPU tests' configuration on
   meshes (2, 1, 2) ring, (1, 2, 2) Ulysses and (2, 2, 1) local, and
   ``spmd_forward``, against the single device at 1e-4; (d) ``moe_ffn``
   (d_model 1024, d_ff 4096, 8 experts over the 4 ranks, top-2, 1024
   tokens a rank, fp32, no token dropped) against
   ``moe_ffn_dense_reference`` on the card, output and router / wd
   gradients at 1e-4 of max abs, and ``pipeline_apply`` (4 stages of
   tanh(x @ w) at d = 1024, 8 microbatches of 16 rows, with and without
   remat) against the sequential stages at 1e-5; (e)
   ``dryrun_multichip(4)`` prints its three ``OK`` lines;
19. the quantized attention at MLA's width (inputs from a thirteenth
   generator, seed + 12): (a) every kernel the quantized attention runs at
   D = 288 (and at 272, zero-padded to 288) against its plain version,
   Hq=8 over Hkv=1, S=300, each called twice and equal bit for bit: the
   forward (``qattn_fwd_wide_kernel``) over int8 and int4 (two packing
   groups a row) ROW CENTERED, folded ROW / CHANNEL / TENSOR, BLOCK_2D,
   an int8 Q with int8 P over block_kv spans of 128 and 256 and with a
   ROW V, bias, a causal window and an fp32 Q (the scalar body; also
   quantized to int8); the
   exact dQ and dK/dV (``qflash_dq_wide_kernel``,
   ``qflash_dkv_wide_kernel`` and the merge of its group split; fp32 on
   the scalar bodies) in those modes with dbias; the full-integer pair at
   levels 1 and 2 (ROW K / CHANNEL V, TENSOR K / V; 16-wide level-2 spans
   on the ``__dp4a`` pair); (b) ``MLAConfig()``'s layer 0 (bf16 weights
   from the seed) on B=2 x 2048 tokens: the absorbed query [q·W_uk |
   q_rope] [2, 16, 2048, 288] over the joint latent [C | K_rope] (int8 ROW
   SYMMETRIC) and [C | 0] as V, forward and backward through
   ``quantized_flash_attention`` (causal; again with ``quantize_q``;
   ``bwd_fullint`` with no mask over a CHANNEL V, the full-integer
   backward's precondition) and ``QuantizedAttention`` (int8 ROW
   CENTERED, causal), the launch counts set to 0 just before each call and
   read after (one forward, one dQ, one dK/dV and its merge, or the
   full-integer pair; the facade's two row quantizers), dq against the
   fp32 dense VJP on the dequantized K/V (the full-integer one against
   the exact call on the same operands) at rel L2 ≤ 0.05, each launched
   kernel against its plain version on the call's own inputs, and the
   profiler's kernel names of the exact and full-integer calls (each
   family at 288); (c) phase 17's 32K construction over the joint
   latent (int8 ROW CENTERED, B=1, H=8, S=32768, a causal window of
   4096): one forward launch and a finite output, then the kernel against
   its plain version at S=8192; (d) the new kernels alone at (b)'s shape,
   events and device ms beside their bounds, plain versions and SDPA over
   the dequantized bf16 K/V (the forward also with an int8 Q, the
   full-integer pair at level 2 too), with ``--parent`` also on the
   parent's library, in turns;
20. MLA serving at DeepSeek's absorbed width 576 (inputs from a
   fourteenth generator, seed + 13): (a) both paged kernels at Hq=16 over
   the one latent head, D=576 with one-state pages and v_tail_zero=64, at
   D=320 (run at 576) and with two-state pages at 576 (the prefill's
   scalar route), bf16 and int8 pools (bf16 q, max abs ≤ 2e-2) and fp32
   (≤ 2e-5): the decode at phase 2's lengths over the engine's capacity,
   the 256-row prefill chunk at three offsets, each call twice, equal bit
   for bit; the dyn GEMM at DeepSeek-V2-Lite's projection shapes bit for
   bit; (b) ``V2_LITE`` (DeepSeek-V2-Lite's widths, 27 layers, random
   weights drawn on the card from the seed) logits through
   ``mla_prefill_chunk`` and ``mla_decode_step`` against the fp32
   ``mla_forward`` with the dense attention (no kernel): float latent
   pool ≤ 0.05 rel L2, ``quantize_mla_weights`` over an int8 latent ≤
   0.25; (c) ``ServingEngine(..., executor=mla_executor())`` serving the
   8 requests, float and W8A8 + int8 latent, the launch counts set to 0
   just before and read after, and no plain version called on a CUDA
   tensor; (d) both paged kernels' times at 576 beside their bounds,
   plain versions and SDPA over the gathered bf16 K/V (the backend torch
   took named), and each engine's device time by kernel over every fifth
   engine step;
21. MLA training at DeepSeek's absorbed width 576 (inputs from a
   fifteenth generator, seed + 14): (a) the flash forward (running max and
   a caller's ``row_max``), dQ with dbias and dK/dV with its merge at
   D=576 (``flash_fwd_latent_kernel`` and the latent bodies in bf16 at the
   flash gates, the fp32 kernels' 32-row tiles at 2e-5) against their
   plain versions, each called twice and equal bit for bit: Hq=16 over
   Hkv=1 causal at S=300, GQA 4 / 2 interleaved, a sliding window, bias
   with dbias, Sq < Skv and Sq > Skv, a row with no live key, D=320 (run
   at 576) and B=2 x S=2048; (b) ``V2_LITE``'s fp32 gradients (weights
   drawn on the card from seed + 14) at B=1, S=1024, every parameter's
   gradient of ``mla_loss_fn`` through the kernels (27 fp32 forward, dQ
   and dK/dV launches) against ``attn_fn=plain_mla_attention`` within
   GRAD_REL_L2_TOL; (c) 8 Adam steps of the bf16 ``V2_LITE`` (weights from
   the seed) on 2 x 2049 tokens through ``make_train_step(...,
   loss=mla_loss_fn)``, the flash counts set to 0 just before each step
   and read after (27 / 27 / 27 and the merges), no plain version called
   on a CUDA tensor, a falling loss, ms a step, tokens/s, the host's span
   of a step and the peak memory; the same steps again from the same
   initial parameters, equal bit for bit; 3 profiled steps (device busy
   time, idle share, device time by kernel); (d) the three kernels alone
   at the slice's attention shape (B=2, Hq=16, Hkv=1, S=2048, D=576,
   causal) by events and device ms beside their bounds, plain versions
   and SDPA (its backend named), and the merge at its workspace.  The
   parent builds no 576 instance, so ``--parent`` times none of them in
   turns (phase 12 times the 288 trio in turns);
22. the quantized latent attention at DeepSeek's absorbed width 576
   (inputs from a sixteenth generator, seed + 21): (a) every quantized
   kernel at D=576, 512 and 320 (both run at 576), Hq=16 over the one
   latent head, S=300, in phase 19 (a)'s modes (an fp32 Q quantized to
   int8 added there too) without the full-integer pair: the forward
   (``qattn_fwd_latent_kernel`` for a bf16 or int8 Q; the 32-row scalar
   body for an fp32 Q), the exact dQ and dK/dV (``qflash_dq_latent_kernel``,
   ``qflash_dkv_latent_kernel`` and the merge; the 32-row scalar bodies for
   fp32), each twice, bit for bit, at phase 19's gates; (b) a one-layer
   copy of ``V2_LITE`` (its widths; weights drawn on the card from the
   seed) on B=2 x 2048 tokens: the absorbed query [2, 16, 2048, 576] over
   the joint [C | K_rope] int8 ROW SYMMETRIC latent and [C | 0] as V
   through ``quantized_flash_attention`` (causal; with ``quantize_q``) and
   ``QuantizedAttention``, and ``mla_absorbed_attention`` over the bare 512
   latent (int8 ROW, 16 heads of 128), forward and backward, the launch
   counts set to 0 just before each call and read after (one forward, one
   dQ, one dK/dV and its merge; the facade's two row quantizers); dq and
   the scale cotangents against the fp32 dense VJP on the dequantized
   latent at rel L2 ≤ 0.05, each launched kernel against its plain version
   on the call's own inputs; the profiler's kernel names; (c) phase 19
   (c)'s 32K construction at 576 (d_c = 512); (d) the three kernels alone
   at (b)'s shape beside their bounds, plain versions and SDPA (MATH at
   576).  With ``--parent``, phase 19 (d) times the 288 quantized kernels
   on the parent's library too, in turns;
23. every head dim from 1 to 576, and the full-integer backward at 576
   (inputs from a seventeenth generator, seed + 22): (a) at D = 8, 20,
   24, 33, 40 and 72 (run at the kernels' widths 32, 64 and 128; the
   paged kernels over the pool's own rows), each kernel twice, bit for
   bit, against its plain version: the flash forward (both modes), dQ and
   dK/dV in bf16 and fp32; the quantized forward over int8 ROW, int4 ROW
   (even D) and with an int8 Q, the exact dQ and dK/dV over int8 and
   int4 ROW; the paged decode and prefill over two-state fp32, bf16, int8
   and int4 pools and one-state latent pages with a zeroed V tail (the
   pool unchanged by the calls); the full-integer pair at levels 1 and 2
   at 40 and 72, and at 576 below one k step (the 32-row ``__dp4a``
   pair); (b) ``MultiHeadAttention`` forward and backward at Stable
   Diffusion 1.5's first UNet level (B=2, 8 heads of 40, S=4096) and
   DiT-XL/2 at 512 px (B=2, 16 heads of 72, S=1024), FULL: one forward,
   dQ and dK/dV launch a call, bf16 O and gradients at the flash gate of
   the plain versions, the fp32 gradients within 1e-3 rel L2 of the dense
   fp32 VJP, the flash kernels' and (over int8 ROW K/V) the quantized
   kernels' times beside their bounds, plain versions and SDPA on the
   same inputs; (c) ``quantized_flash_attention(..., bwd_fullint=True)``
   over phase 22's V2-Lite joint latent (B=2, Hq=16 over one head,
   S=2048, D=576, FULL, ROW K / CHANNEL V) at levels 1 and 2: one
   forward, one dQ, one dK/dV and one merge a call, dq and the scale
   cotangents within 0.05 rel L2 of the dense fp32 VJP, a second call bit
   for bit, each kernel against its plain version, the profiler's kernel
   names, the pair's times beside its bound, plain version and SDPA's
   MATH backward; then the paged kernels' times at 40 and 72;
24. the flash trio and the paged pair above 576, on the split-D kernels
   (``csrc/split_d_attention.cu``: O's lanes split over CTAs, 256 a CTA;
   inputs from an eighteenth generator, seed + 23): (a) at D = 580 (run
   at 592), 608, 640, 1024 and 1152, and once at 2048, the forward (both
   modes), dQ with dbias and dK/dV (its merge) in bf16 and fp32 under a
   causal group of 16 over one head, an interleaved causal window of 4
   over 2, and at 640 a bias and sparse rows, at 1024 a full mask, each
   twice, bit for bit, at the flash gates of the plain versions; the
   paged decode and prefill at each width (and 1088) over fp32, bf16,
   int8 and int4 pools and latent pages (64 zeroed V lanes at 640 and
   1088); one ``flash_attention`` forward and backward (one forward, dQ,
   dK/dV and merge) and one decode (its split kernel and merge) counted;
   (b) the trio at B=2, Hq=16 over one head, S=2048, causal, bf16 at
   D = 640 and 1024, the paged pair over latent pages at the engine's
   decode lengths and the 256-row chunk at offset 512, and the forward at
   Perceiver IO's image cross-attention (B=1, one head, 512 latents over
   50,176 inputs, D=1024: its KV axis split, ``split_d_fwd_splits``, one
   kernel and one ``split_d_fwd_merge_kernel`` a call, counted, held to
   the plain version and twice bit for bit, the merge alone against its
   plain version), each beside its bound, plain version and SDPA (its
   backend named); (c) a ``TransformerConfig`` with 8 query heads of
   640 over 2 KV heads at the flagship's other widths, depth cut to 2
   layers: the cached logits within 5e-2 rel L2 of the fp32 forward,
   phase 5's 8 requests served on the split-D paged kernels (counted),
   the fp32 gradients within 1e-3 of plain attention's, 4 train steps
   (one forward, dQ and dK/dV a layer a step, counted) and a rerun of them
   equal bit for bit;
25. the quantized attention above 576, on the split-D kernels
   (``csrc/split_d_quantized.cu``, ``csrc/split_d_quantized_bwd.cu``;
   inputs from a nineteenth generator, seed + 24): (a) at D = 580 (run at
   592), 608, 640, 1024 and 1152 every quantized kernel against its plain
   version under 16 causal q heads over one (phase 19 (a)'s modes: the
   forward over int8 / int4 ROW, folded ROW / CHANNEL / TENSOR, BLOCK_2D,
   an int8 Q with bf16 and int8 P over 128- and 256-key spans, bias, a
   window, fp32 Q; the exact dQ with dbias and dK/dV; the full-integer
   pair at levels 1 and 2), BLOCK_2D blocks that straddle the 256-lane
   slices at 608, 640 and 1152, sparse rows with an empty one at 640, a
   level-2 span below one k step at 640 and one forward at 2048, each
   twice, bit for bit; (b) the five kernels at B=2, Hq=16 over one head,
   S=2048, int8 ROW K/V (causal; the full-integer pair FULL over CHANNEL
   V) at D = 640 and 1024 and the ``QuantizedAttention`` forward at
   Perceiver IO's cross-attention shape (its KV axis split as in 24 (b):
   two quantizers, one kernel and one merge a call, counted), each beside
   its bound, plain version, SDPA over the dequantized bf16 K/V and phase
   24's float split-D time; with ``--parent`` the five kernels in turns on
   the parent's library too, and the full-integer pair and the exact dQ
   bit for bit with its outputs (their int32 sums are exact); (c) phase
   24's head dim 640 model:
   ``quantized_forward(quantize_weights(params), tokens, cfg,
   quantize_kv=True)`` within 0.25 rel L2 of the fp32 forward with one
   split-D quantized forward a layer (counted), then one
   ``quantized_flash_attention`` forward and backward at its layer shape
   with ``bwd_fullint`` off and on (counted), gradients within 0.05 rel
   L2.

Phase 10 and 11 hold the quantized forward to its plain version over the
key spans the main path gives it: the TPU's ``block_kv`` where P is int8.
Phases 10 (f), 13 (c), 8, 11 (d) and 12 (h) log which body the quantized
forward and the head-pair call, the quantized-A and the weight-only GEMMs
(folded and dequantizing), the flash forward and the dQ and dK/dV kernels,
the exact and the full-integer ones, and the paged kernels run
(``qattn_body``, ``qa_gemm_body``, ``wo_gemm_body``, ``fwd_body``,
``dq_body``, ``dkv_body``, ``fullint_body``, ``decode_body``,
``prefill_body``: tensor cores, or fp32 FMAs / ``__dp4a``).

``--parent DIR`` (a checkout of the parent commit, e.g. ``git archive``
into a directory ``.gitignore`` lists) also builds DIR's kernels, at once
with this checkout's, and times every kernel the phases time on both
libraries in turns (parent, change, change, parent) through the same
wrappers (a parent whose weight-only kernels write fp32 only runs
``quantized_matmul`` as it did then: fp32, then the cast); the turns go
into the log, a summary line each, and the redesigned kernels' record
entries.

Every phase raises on failure, so the script exits non-zero.  It prints
the kernels' record as one JSON line and, as the very last line,
``{"ok": true, "device": {...}}``.  It needs a CUDA device: without one it
exits 2 and prints no result.  The port is imported from the checkout, so
the script alone, outside the repository, fails at import.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import ctypes
import dataclasses
import hashlib
import importlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

from metal_flash_attention_plus_tpu_torch import _build
from metal_flash_attention_plus_tpu_torch.attention import masking
from metal_flash_attention_plus_tpu_torch.attention.descriptor import (
    AttentionDescriptor,
)
from metal_flash_attention_plus_tpu_torch.attention.multi_head import (
    MultiHeadAttention,
)
from metal_flash_attention_plus_tpu_torch.attention.tuning import (
    AttentionTuner,
    tile_of,
)
from metal_flash_attention_plus_tpu_torch.attention.precisions import (
    TOLERANCES,
)
from metal_flash_attention_plus_tpu_torch.attention.quantized import (
    QuantizedAttention,
    QuantizedAttentionConfig,
)
from metal_flash_attention_plus_tpu_torch.models.cached import (
    decode_step,
    init_cache,
    prefill_chunk,
)
from metal_flash_attention_plus_tpu_torch.models.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from metal_flash_attention_plus_tpu_torch.models.mla_transformer import (
    MLAConfig,
    init_mla_params,
    mla_forward,
    mla_layer_kv,
    mla_layer_q,
    mla_loss_fn,
    plain_mla_attention,
)
from metal_flash_attention_plus_tpu_torch.models.quantized_inference import (
    WEIGHT_CFG,
    quantize_mla_weights,
    quantize_weights,
    quantized_forward,
)
from metal_flash_attention_plus_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
    make_train_step,
    plain_attention,
    rms_norm,
    trainable_parameters,
)
from metal_flash_attention_plus_tpu_torch.ops import (
    flash_attention_bwd as fbwd,
)
from metal_flash_attention_plus_tpu_torch.ops import (
    quantized_attention as tqa,
)
# The module (``ops.flash_attention`` names its function too).
tfa = importlib.import_module(
    "metal_flash_attention_plus_tpu_torch.ops.flash_attention")
from metal_flash_attention_plus_tpu_torch.ops.flash_attention import (
    DTYPE_CODES,
    LOG2E,
    BlockSizes,
    estimate_row_max_scaled,
    flash_attention,
    flash_attention_forward,
    flash_attention_forward_plain,
    flash_fwd,
    flash_width,
    fwd_body,
    row_ranges_tensor,
)
from metal_flash_attention_plus_tpu_torch.ops.flash_attention_bwd import (
    dkv_body,
    dq_body,
    flash_attention_dkv_plain,
    flash_attention_dq_plain,
    flash_dkv,
    flash_dq,
    fullint_body,
)
from metal_flash_attention_plus_tpu_torch.ops.mla import (
    mla_absorbed_attention,
    mla_decompress,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_attention import (
    KV_TILE,
    QAttnMode,
    hpack_arguments,
    hpack_fwd,
    hpack_fwd_plain,
    int8_p_tile,
    pack_heads,
    qattn_arguments,
    qattn_body,
    qattn_fwd,
    qattn_fwd_plain,
    quantized_flash_attention_forward,
    quantized_flash_attention_qat,
)
from metal_flash_attention_plus_tpu_torch.ops.gemm import (
    GEMMDescriptor,
    matmul,
)
from metal_flash_attention_plus_tpu_torch.ops.quantized_gemm import (
    comp_arguments,
    comp_gemm,
    comp_gemm_plain,
    comp_small_body,
    comp_small_gemm,
    comp_small_gemm_plain,
    compensated_matmul,
    dyn_gemm,
    dyn_gemm_plain,
    dyn_tile,
    qa_arguments,
    qa_folded_gemm,
    qa_folded_gemm_plain,
    qa_gemm,
    qa_gemm_body,
    qa_gemm_plain,
    quantize_rows,
    weight_scales,
    wo_arguments,
    wo_call,
    wo_folded_gemm,
    wo_folded_gemm_plain,
    wo_gemm,
    wo_gemm_body,
    wo_gemm_plain,
    wo_tile,
)
from metal_flash_attention_plus_tpu_torch.ops import (
    quantized_gemm as qgemm,
)
from metal_flash_attention_plus_tpu_torch.ops import (
    runtime_quantization as rtq,
)
from metal_flash_attention_plus_tpu_torch.entry import dryrun_multichip
from metal_flash_attention_plus_tpu_torch.parallel import (
    AXES,
    broadcast_from_last_stage,
    init_moe_params,
    make_mesh,
    moe_ffn,
    pipeline_apply,
    ring_attention,
    ring_attention_zigzag,
    ulysses_attention,
    zigzag_postshard,
    zigzag_preshard,
)
from metal_flash_attention_plus_tpu_torch.parallel.comm import all_reduce
from metal_flash_attention_plus_tpu_torch.parallel.moe import (
    moe_ffn_dense_reference,
)
from metal_flash_attention_plus_tpu_torch.parallel.spmd import (
    ShardingConfig,
    make_spmd_loss_and_grad,
    make_spmd_train_step,
    mesh_rank,
    shard_params,
    spmd_forward,
    unshard_params,
)
from metal_flash_attention_plus_tpu_torch.quant import capabilities
from metal_flash_attention_plus_tpu_torch.quant.compensation import (
    dequantized_gemm_reference,
)
from metal_flash_attention_plus_tpu_torch.quant.params import (
    QuantConfig,
    QuantGranularity,
    QuantStrategy,
    int8_blockwise,
)
from metal_flash_attention_plus_tpu_torch.quant.serialization import (
    load_quantized,
    save_quantized,
)
from metal_flash_attention_plus_tpu_torch.quant.tensor import (
    QuantizedTensor,
    dequantize,
    quantize,
    unpack_int4,
)
from metal_flash_attention_plus_tpu_torch.reference.attention import (
    reference_attention,
    reference_attention_vjp,
)
from metal_flash_attention_plus_tpu_torch.serving.engine import (
    ServingEngine,
    mla_executor,
)
from metal_flash_attention_plus_tpu_torch.serving.kv_cache import unpack_kv4
from metal_flash_attention_plus_tpu_torch.serving.paged_attention import (
    decode_body,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_prefill_attention,
    paged_prefill_attention_plain,
    prefill_body,
)
from metal_flash_attention_plus_tpu_torch.utils.debug import dump_lowered
from metal_flash_attention_plus_tpu_torch.utils.roofline import H100_SXM
from metal_flash_attention_plus_tpu_torch.utils.profiling import (
    DEEPSEEK_V2_LITE,
    GEMM_SHAPES,
    NORTH_STAR_BLOCKS,
    NORTH_STAR_SHAPE,
    north_star_grads,
    north_star_inputs,
    gemm_arm,
    measure_held,
    clone_params,
    named_parameters,
    params_digest,
    smoke_requests,
    train_tokens,
    train_twice,
)

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s,
# bf16 tensor-core flop/s and int8 tensor-core op/s (utils/roofline.py's
# H100_SXM).
HBM_BYTES_PER_S = H100_SXM.hbm_gbps * 1e9
BF16_FLOPS = H100_SXM.bf16_tflops * 1e12
INT8_OPS = H100_SXM.int8_tops * 1e12

# Kernel vs plain version, both on identical bf16 inputs: they round the
# same values to bf16 at the same places (q after scaling, P before P.V);
# what differs is the order of the fp32 sums and of exp, and the online vs
# one-pass rescaling of P before its bf16 rounding.  Max abs error; no
# looser than TOLERANCES["mixed"].
KERNEL_TOL = 2e-2
# Cached bf16 serving path vs the fp32 oracle, relative L2 over the logits:
# bf16 activations and bf16 K/V through 8 layers.
LOGITS_REL_L2_TOL = TOLERANCES["mixed"]

# Flash kernels vs plain versions: max abs error over the plain version's
# max abs.  bf16 as the paged kernels (the same roundings at the same
# places, fp32 sums in another order); L in bf16 at TOLERANCES["lse"];
# fp32 at TOLERANCES["fp32"].
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: TOLERANCES["fp32"]}
LSE_TOL = {torch.bfloat16: TOLERANCES["lse"],
           torch.float32: TOLERANCES["fp32"]}
# Full-width fp32 gradients, flash kernels vs the dense plain attention:
# relative L2 per parameter; fp32 throughout, sums in another order.
GRAD_REL_L2_TOL = 1e-3
# Quantized serving logits vs the fp32 oracle on the dequantized weights,
# relative L2: the repo's quantized gates (W8A8 + int8 pool, W4A8 + int4
# pool); the difference is the run-time int8 activations and the
# quantized K/V.
QUANT_LOGITS_TOL = {8: TOLERANCES["int8_rel"], 4: TOLERANCES["int4_rel"]}
# The flagship's projections (N, K) in the order of one layer, and the
# unembedding: one model call runs 8 × 7 + 1 = 57 dynamic GEMMs.
PROJ_SHAPES = {"wq": (1024, 1024), "wk": (256, 1024), "wv": (256, 1024),
               "wo": (1024, 1024), "wg": (4096, 1024), "wu": (4096, 1024),
               "wd": (1024, 4096)}
UNEMBED_SHAPE = (32768, 1024)
# MLAConfig()'s projections (N, K) that the flagship has not: the RoPE
# queries and the shared RoPE key (wq, wdkv, wo and the MLP are above).
MLA_PROJ_SHAPES = {"wqr": (512, 1024), "wkr": (32, 1024)}
# The train step's shapes: the flagship at batch 4 × 2048 tokens.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8

DEV = torch.device("cuda")
SOURCE = "metal_flash_attention_plus_tpu_torch/csrc/paged_attention.cu"
GEMM_SOURCE = "metal_flash_attention_plus_tpu_torch/csrc/quantized_gemm.cu"
GEMM_TPU = "metal_flash_attention_plus_tpu/ops/quantized_gemm.py"
TPU_FILE = "metal_flash_attention_plus_tpu/serving/paged_attention.py"
FLASH_SOURCE = "metal_flash_attention_plus_tpu_torch/csrc/flash_attention.cu"
FLASH_TPU = "metal_flash_attention_plus_tpu/ops/flash_attention.py"
FLASH_BWD_TPU = "metal_flash_attention_plus_tpu/ops/flash_attention_bwd.py"
QATTN_SOURCE = ("metal_flash_attention_plus_tpu_torch/csrc/"
                "quantized_attention.cu")
RTQ_SOURCE = ("metal_flash_attention_plus_tpu_torch/csrc/"
              "runtime_quantization.cu")
QATTN_TPU = "metal_flash_attention_plus_tpu/ops/quantized_attention.py"
RTQ_TPU = "metal_flash_attention_plus_tpu/ops/runtime_quantization.py"
# What the record says of the kernels moved onto the tensor cores.
REDESIGNED = ("mma.sync tensor-core body for its bf16 (and int8) instances, "
              "cp.async staging")
QBWD_SOURCE = ("metal_flash_attention_plus_tpu_torch/csrc/"
               "quantized_attention_bwd.cu")
# What the record says of the redesigned runtime quantizers.
RTQ_REDESIGNED = {
    "runtime_quantize_row": "sub-warp rows (a group of 8 lanes at K = 64), "
                            "16-byte loads held in registers, every pass "
                            "from them, 8-byte code stores",
    "runtime_quantize_block": "each block's slab split over a thread block "
                              "cluster (16 blocks x 16 CTAs at bs 64, 8 x 16 "
                              "at bs 128), 16-byte loads held in registers, "
                              "one statistics pass, the partials exchanged "
                              "in rank order through distributed shared "
                              "memory",
}
# The device kernel each record entry's wrapper launches at the entry's
# (main-path) shape.
DEVICE_KERNELS = {
    "paged_decode": "paged_decode_tc_kernel",
    "paged_prefill": "paged_prefill_tc_kernel", "dyn_gemm": "dyn_tc_kernel",
    "flash_fwd": "flash_fwd_tc_kernel", "flash_dq": "flash_dq_tc_kernel",
    "flash_dkv": "flash_dkv_tc_kernel", "qattn_fwd": "qattn_fwd_tc_kernel",
    "hpack_fwd": "qattn_fwd_tc_kernel",
    "runtime_quantize_row": "rtq_row_kernel",
    "runtime_quantize_block": "rtq_block_kernel",
    "qflash_dq": "qflash_dq_tc_kernel", "qflash_dkv": "qflash_dkv_tc_kernel",
    "fullint_dq": "fullint_dq_tc_kernel",
    "fullint_dkv": "fullint_dkv_tc_kernel",
    "wo_folded_gemm": "wo_tc_kernel", "wo_gemm": "wo_tc_kernel",
    "qa_folded_gemm": "qa_tc_kernel", "qa_gemm": "qa_tc_kernel",
    "comp_gemm": "comp_tc_kernel", "comp_small_gemm": "comp_tc_kernel",
    "flash_fwd_static_max": "flash_fwd_tc_kernel",
    "flash_dkv_merge": "flash_dkv_merge_kernel",
    "flash_fwd_latent": "flash_fwd_latent_kernel",
    "flash_dq_latent": "flash_dq_latent_kernel",
    "flash_dkv_latent": "flash_dkv_latent_kernel",
    "qattn_fwd_wide": "qattn_fwd_wide_kernel",
    "qflash_dq_wide": "qflash_dq_wide_kernel",
    "qflash_dkv_wide": "qflash_dkv_wide_kernel",
    "fullint_dq_d288": "fullint_dq_tc_kernel",
    "fullint_dkv_d288": "fullint_dkv_tc_kernel",
    "fullint_dq_d576": "fullint_dq_tc_kernel",
    "fullint_dkv_d576": "fullint_dkv_tc_kernel",
}
# The flash kernels at MLA's D = 288 (bf16) and what the record says of
# them.
WIDE_KERNELS = {"flash_fwd": "flash_fwd_wide_kernel",
                "flash_dq": "flash_dq_wide_kernel",
                "flash_dkv": "flash_dkv_wide_kernel"}
WIDE_REDESIGNED = {
    "flash_fwd": "bf16 mma.sync with tiles cut for D = 288: "
                 "flash_fwd_tc_kernel's body (4 warps x 16 query rows, O's "
                 "288 lanes in registers) over 32-key K / V tiles "
                 "double-buffered by cp.async, 113,664 bytes of shared "
                 "memory, two CTAs an SM",
    "flash_dq": "bf16 mma.sync with tiles cut for D = 288: Q and dO "
                "resident, 32-key K / V tiles double-buffered by cp.async, "
                "8 warps (16 keys x 144 lanes a warp)",
    "flash_dkv": "bf16 mma.sync with tiles cut for D = 288: K and V "
                 "resident, 48-row Q / dO steps double-buffered by "
                 "cp.async, 12 warps (16 queries / 96 lanes a warp), the GQA "
                 "group dealt over dkv_splits CTAs a key tile and summed in "
                 "split order by flash_dkv_merge_kernel",
}
# comp_small_gemm's kernel for the blocks comp_small_body routes to the
# scalar tile (not a multiple of 16; 13 (a)'s BLOCK 8 mode).
COMP_SMALL_SCALAR = "comp_small_kernel"
# The paged decode's second launch where its KV axis is split.
PAGED_MERGE = "paged_decode_merge_kernel"
# What the record says of the redesigned paged kernels.
PAGED_REDESIGNED = {
    "paged_decode": "split-KV over CTAs (decode_splits), a cp.async ring "
                    "gathering token rows by page id, bf16 mma.sync for "
                    "the bf16 instances, the splits merged in a fixed "
                    "order by paged_decode_merge_kernel",
    "paged_prefill": "FlashAttention-2 on bf16 mma.sync (flash_fwd_tc_"
                     "kernel's frame), a cp.async ring gathering token rows "
                     "by page id, P.V over the kept lanes",
}


def log(msg: str):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# The kernels library of a parent checkout (``--parent DIR``) and the
# timings taken on it beside this checkout's, in turns: (label, {"parent":
# [ms, ms], "change": [ms, ms]}).
PARENT = {"lib": None, "turns": []}


# Arguments a parent's library lacks, by entry point: (a symbol that only
# newer libraries have, the index of the first argument it lacks); it
# takes the arguments before that one and the stream.  The weight-only
# entry points from before the kernels stored the caller's dtype (no
# ``mfa_wo_tc_body``) lack the out type, tile rows, K splits and workspace:
# their kernels write fp32 and choose their own tile.  The dynamic GEMM
# from before the s8 tile (no ``mfa_comp_small_body``) lacks the tile rows
# and K splits: its kernel chooses its own.  The paged decode from before
# the split KV axis (no ``mfa_paged_bodies``) lacks the splits and the
# workspace.  The block quantizer from before the cluster (no
# ``mfa_rtq_row_group``) lacks the cluster size.  The flash forward from
# before the static-max mode (no ``mfa_flash_static_max_body``) lacks the
# row_max pointer: it runs the running max only.  The flash dK/dV from
# before its wide body (no ``mfa_flash_dkv_merge``) lacks the splits and
# the workspace: it takes one CTA a key tile.  The exact quantized
# backward from before its wide kernels (no ``mfa_qattn_body``) lacks the
# splits and the workspace: it stops at D = 256, where no call splits.
# The flash and quantized forwards from before the split-D forward's KV
# split (no ``mfa_split_d_fwd_merge``) lack the splits and the workspace:
# one walk.  Where an entry point lacks several, the first one counts.
LEGACY_ARGS = {"mfa_flash_fwd": (("mfa_flash_static_max_body", 19),
                                 ("mfa_split_d_fwd_merge", 20)),
               "mfa_qattn_fwd": (("mfa_split_d_fwd_merge", 31),),
               "mfa_qflash_bwd": (("mfa_qattn_body", 35),),
               "mfa_flash_dkv": (("mfa_flash_dkv_merge", 21),),
               "mfa_wo_folded_gemm": (("mfa_wo_tc_body", 9),),
               "mfa_wo_gemm": (("mfa_wo_tc_body", 12),),
               "mfa_dyn_gemm": (("mfa_comp_small_body", 12),),
               "mfa_paged_decode": (("mfa_paged_bodies", 19),),
               "mfa_rtq_blocks": (("mfa_rtq_row_group", 12),)}


@contextlib.contextmanager
def kernels_of(lib):
    """Run the port's kernel wrappers on ``lib``'s kernels (the same C
    interface) instead of this checkout's.  An entry point of LEGACY_ARGS
    that ``lib`` has in its older form is called without the arguments it
    lacks.  A library whose weight-only kernels write fp32 only:
    ``quantized_matmul`` stores fp32 and casts meanwhile, as it did over
    those kernels.  A library without the small-block tensor-core tile:
    ``comp_small_gemm`` takes the scalar tile, its only kernel.  A library
    without the split dK/dV: ``flash_dkv`` plans one split (no merge).  A
    library without the split-D forward's KV split: the forwards plan one
    run (no merge)."""
    own = (_build.kernel_function, qgemm.WO_OUT_TYPES, qgemm.comp_small_body,
           fbwd.dkv_splits, tfa.split_d_fwd_splits)

    def function(name, argtypes):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        lacks = [i for sym, i in LEGACY_ARGS.get(name, ())
                 if not hasattr(lib, sym)]
        if not lacks:
            fn.argtypes = list(argtypes)
            return fn
        i = min(lacks)
        fn.argtypes = list(argtypes[:i]) + list(argtypes[-1:])

        def older(*args):
            if (name.startswith("mfa_wo")
                    and args[i] != qgemm.WO_OUT_TYPES[torch.float32]):
                raise ValueError(f"{name} of this library writes fp32 only")
            return fn(*args[:i], args[-1])
        return older

    _build.kernel_function = function
    if not hasattr(lib, "mfa_wo_tc_body"):
        qgemm.WO_OUT_TYPES = {torch.float32: own[1][torch.float32]}
    if not hasattr(lib, "mfa_comp_small_body"):
        qgemm.comp_small_body = lambda bs: "scalar"
    if not hasattr(lib, "mfa_flash_dkv_merge"):
        fbwd.dkv_splits = lambda *shape: 1
    if not hasattr(lib, "mfa_split_d_fwd_merge"):
        tfa.split_d_fwd_splits = tqa.split_d_fwd_splits = (
            lambda *shape, one_walk=False: 1)
    try:
        yield
    finally:
        (_build.kernel_function, qgemm.WO_OUT_TYPES,
         qgemm.comp_small_body, fbwd.dkv_splits) = own[:4]
        tfa.split_d_fwd_splits = tqa.split_d_fwd_splits = own[4]


def parent_turns(label, t, kernel, iters, device=False, parent_kernel=None,
                 by_kernel=False):
    """With ``--parent``: ``kernel`` timed on the parent's library and on
    this checkout's in turns (parent, change, change, parent), into
    ``t["parent_turns_ms"]`` and the summary (``parent_kernel`` in the
    parent's turns where it is given); with ``device``, each turn's device
    ms too (``device_ms``), into ``t["parent_turns_device_ms"]``, and with
    ``by_kernel`` each turn's device ms by kernel (``kernel_label``) into
    ``t["parent_turns_device_ms_by_kernel"]``; nothing without
    ``--parent``."""
    if PARENT["lib"] is None:
        return
    turns = {"parent": [], "change": []}
    dev = {"parent": [], "change": []}
    per = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        fn = parent_kernel if who == "parent" and parent_kernel else kernel
        with (kernels_of(PARENT["lib"]) if who == "parent"
              else contextlib.nullcontext()):
            turns[who].append(time_ms(fn, iters, warmup=1))
            if device or by_kernel:
                by = device_ms_by_label(fn, iters)
                dev[who].append(sum(by.values()))
                per[who].append(by)
    t["parent_turns_ms"] = turns
    PARENT["turns"].append((label, turns))
    log(f"{label} parent / change turns: " + json.dumps(turns))
    if device or by_kernel:
        t["parent_turns_device_ms"] = dev
        PARENT["turns"].append((f"{label} (device ms)", dev))
        log(f"{label} parent / change turns, device ms: " + json.dumps(dev))
    if by_kernel:
        t["parent_turns_device_ms_by_kernel"] = per
        log(f"{label} parent / change turns, device ms by kernel: "
            + json.dumps(per))


def parent_bits(kernel):
    """With ``--parent``: whether ``kernel()``'s outputs (a tensor or a
    tuple, None skipped) on the parent's library and on this checkout's
    are the same bits."""
    with kernels_of(PARENT["lib"]):
        theirs = kernel()
    ours = kernel()
    torch.cuda.synchronize()
    theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    ours = ours if isinstance(ours, tuple) else (ours,)
    return all(torch.equal(a, b) for a, b in zip(theirs, ours)
               if a is not None)


def log_parent_summary():
    """One line per timing taken in turns: the parent's and the change's
    times and the change's mean over the parent's."""
    for label, t in PARENT["turns"]:
        p, c = t["parent"], t["change"]
        ratio = f"{sum(c) / sum(p):.4f}" if sum(p) else "n/a"
        log(f"turns {label}: parent {p[0]:.5g} / {p[1]:.5g} ms, change "
            f"{c[0]:.5g} / {c[1]:.5g} ms, change/parent {ratio}")


# --------------------------------------------------------------------------
# Phase 1: build
# --------------------------------------------------------------------------


def build_all(parent=None):
    """nvcc (kernels) and g++ (runtime) started together; with ``parent``
    (a checkout of the parent commit), its kernels too, into
    ``PARENT["lib"]``."""
    errors = []

    def run(name):
        try:
            if name == "parent":
                csrc = Path(parent) / _build.CSRC_DIR.relative_to(
                    _build.REPO_ROOT)
                PARENT["lib"] = ctypes.CDLL(str(_build.build_kernels(
                    csrc.resolve(), "mfa_kernels_parent")))
            else:
                _build.load_library(name)
        except BaseException as exc:  # reported and re-raised below
            errors.append(exc)

    names = ("kernels", "runtime") + (("parent",) if parent else ())
    threads = [threading.Thread(target=run, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    log("build seconds: " + json.dumps(
        {k: round(v, 2) for k, v in _build.build_seconds.items()}))


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------


def paged_inputs(rng, lengths, hkv, d, pt, num_pages, max_pages,
                 dtype=torch.bfloat16):
    """Random pool [Hkv, NP+1, 2PT, D] (trash page random too) and
    trash-padded tables over scattered pages."""
    pool = torch.from_numpy(
        rng.standard_normal((hkv, num_pages + 1, 2 * pt, d), np.float32)
    ).to(DEV, dtype)
    return pool, page_tables(rng, lengths, pt, num_pages, max_pages)


def page_tables(rng, lengths, pt, num_pages, max_pages):
    """Trash-padded page tables [len(lengths), max_pages] over scattered
    pages, on the card."""
    perm = rng.permutation(num_pages)
    table = np.full((len(lengths), max_pages), num_pages, np.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        pages = -(-int(n) // pt)
        table[i, :pages] = perm[nxt: nxt + pages]
        nxt += pages
    assert nxt <= num_pages
    return torch.from_numpy(table).to(DEV)


def max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# --------------------------------------------------------------------------
# Phase 2: paged kernels vs plain versions
# --------------------------------------------------------------------------


def check_decode(rng, d):
    b, hq, hkv, pt, num_pages, max_pages = 8, 16, 4, 256, 256, 16
    lengths = np.asarray([1, pt, pt + 1, 1800, 3 * pt + 17, 37, 1024, 4000],
                         np.int32)
    pool, table = paged_inputs(rng, lengths, hkv, d, pt, num_pages, max_pages)
    q = torch.from_numpy(rng.standard_normal((b, hq, d), np.float32)).to(
        DEV, torch.bfloat16)
    ln = torch.from_numpy(lengths).to(DEV)
    out = paged_decode_attention(q, pool, table, ln, page_tokens=pt)
    torch.cuda.synchronize()
    ref = paged_decode_attention_plain(q, pool, table, ln, page_tokens=pt)
    err = max_abs(out, ref)
    log(f"decode D={d}: max abs err {err:.3e} (tol {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"paged decode D={d} disagrees: {err}")
    return err


def check_prefill(rng, offset):
    hq, hkv, d, pt, chunk, num_pages, max_pages = 16, 4, 64, 256, 256, 64, 16
    pool, table = paged_inputs(rng, [offset + chunk], hkv, d, pt, num_pages,
                               max_pages)
    row = table[0].contiguous()
    q = torch.from_numpy(rng.standard_normal((hq, chunk, d), np.float32)).to(
        DEV, torch.bfloat16)
    out = paged_prefill_attention(q, pool, row, offset, page_tokens=pt)
    torch.cuda.synchronize()
    ref = paged_prefill_attention_plain(q, pool, row, offset, page_tokens=pt)
    err = max_abs(out, ref)
    log(f"prefill offset={offset}: max abs err {err:.3e} (tol {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"paged prefill offset={offset} disagrees: {err}")
    return err


def paged_pool_f32(gen, kind, hkv, num_pages, pt, d, states):
    """An fp32 pool (``f32``), or an int8 one (``int8`` halves or one
    state, the ``int4`` byte) with per-token scales, from ``gen`` on the
    card → (pool, kwargs)."""
    rows = pt if kind == "int4" else states * pt
    shape = (hkv, num_pages + 1, rows, d)
    if kind == "f32":
        return torch.randn(shape, generator=gen, device=DEV), {}
    pool = torch.randint(-128, 128, shape, generator=gen, device=DEV)
    step = 7.0 if kind == "int4" else 127.0
    ks, vs = ((torch.rand((hkv, num_pages + 1, 1, pt), generator=gen,
                          device=DEV) * 1.5 + 0.5) / step for _ in range(2))
    return pool.to(torch.int8), dict(k_scales=ks, v_scales=vs,
                                     kv_bits=4 if kind == "int4" else 8)


def check_paged_fp32(seed):
    """Both paged kernels with an fp32 q (the decode on paged_decode_kernel,
    the prefill on paged_prefill_kernel, both fp32 FMAs) against their plain
    versions at TOLERANCES["fp32"]: float, int8 and int4 pools at the
    flagship's geometry (D=64, phase 2's lengths; prefill of a 256-token
    chunk at offset 300), and MLA's one-state latent pages (Hq=16 over
    Hkv=1, D=288, v_tail_zero=32), float and int8; then the bf16 and fp32
    decode twice on the same inputs, equal bit for bit.  Inputs from a
    seventh generator (seed + 6) → ({label: max abs err}, {label:
    bitwise equal})."""
    rng = np.random.default_rng(seed + 6)
    gen = device_generator(rng)
    tol = TOLERANCES["fp32"]
    pt, num_pages, max_pages, chunk, offset = 256, 256, 16, 256, 300
    lengths = np.asarray([1, pt, pt + 1, 1800, 3 * pt + 17, 37, 1024, 4000],
                         np.int32)
    ln = torch.from_numpy(lengths).to(DEV)
    errs, same = {}, {}
    geoms = [("flagship", 16, 4, 64, 2, 0, kind)
             for kind in ("f32", "int8", "int4")]
    geoms += [("mla", MLA_HQ, 1, MLA_D, 1, MLA_VTZ, kind)
              for kind in ("f32", "int8")]
    for geom, hq, hkv, d, states, vtz, kind in geoms:
        pool, kw = paged_pool_f32(gen, kind, hkv, num_pages, pt, d, states)
        kw.update(page_tokens=pt, v_tail_zero=vtz)
        table = page_tables(rng, lengths, pt, num_pages, max_pages)
        q = torch.randn((len(lengths), hq, d), generator=gen, device=DEV)
        label = f"decode {geom} {kind}"
        out = paged_decode_attention(q, pool, table, ln, **kw)
        torch.cuda.synchronize()
        errs[label] = max_abs(out, paged_decode_attention_plain(
            q, pool, table, ln, **kw))
        row = page_tables(rng, [offset + chunk], pt, num_pages,
                          max_pages)[0]
        qp = torch.randn((hq, chunk, d), generator=gen, device=DEV)
        out = paged_prefill_attention(qp, pool, row, offset, **kw)
        torch.cuda.synchronize()
        errs[f"prefill {geom} {kind}"] = max_abs(
            out, paged_prefill_attention_plain(qp, pool, row, offset, **kw))
    log("paged kernels, fp32 q, max abs err (tol "
        f"{tol}; bodies {decode_body(torch.float32, 64)} / "
        f"{prefill_body(torch.float32, 64, 2, 0)}): " + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise AssertionError(f"paged kernels (fp32) disagree: {bad}")
    for dtype in (torch.bfloat16, torch.float32):
        pool, _ = paged_pool_f32(gen, "f32", 4, num_pages, pt, 64, 2)
        pool = pool.to(dtype)
        table = page_tables(rng, lengths, pt, num_pages, max_pages)
        q = torch.randn((len(lengths), 16, 64), generator=gen,
                        device=DEV).to(dtype)
        outs = [paged_decode_attention(q, pool, table, ln, page_tokens=pt)
                for _ in range(2)]
        torch.cuda.synchronize()
        same[str(dtype)] = torch.equal(outs[0], outs[1])
    log("paged decode, two calls bit for bit equal: " + json.dumps(same))
    if not all(same.values()):
        raise AssertionError(f"paged decode is not deterministic: {same}")
    return errs, same


# --------------------------------------------------------------------------
# Phase 3: flash kernels vs plain versions
# --------------------------------------------------------------------------


def rel_err(out, ref) -> float:
    """Max abs error over the reference's max abs; -inf (empty rows) must
    match exactly."""
    out, ref = out.float(), ref.float()
    finite = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(out), finite) or not torch.equal(
            out[~finite], ref[~finite]):
        return float("inf")
    scale = ref[finite].abs().max().clamp_min(1e-30)
    return ((out[finite] - ref[finite]).abs().max() / scale).item()


def flash_inputs(rng, b, hq, hkv, sq, skv, d, dtype, bias_shape=None):
    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, np.float32)).to(DEV)

    q, k, v, do = t(b, hq, sq, d), t(b, hkv, skv, d), t(b, hkv, skv, d), t(
        b, hq, sq, d)
    bias = None if bias_shape is None else t(*bias_shape)
    return [x.to(dtype) for x in (q, k, v, do)] + [bias]


def check_flash(rng, label, b, hq, hkv, sq, skv, d, dtype,
                mask=masking.CAUSAL, ranges=None, bias_shape=None,
                interleaved=False):
    """Forward, dQ and dK/dV kernels against their plain versions on the
    same inputs → {output: (rel err, max abs err)}; raises past a gate."""
    q, k, v, do, bias = flash_inputs(rng, b, hq, hkv, sq, skv, d, dtype,
                                     bias_shape)
    rr = row_ranges_tensor(mask, sq, skv, ranges, DEV)
    kw = dict(bias=bias, scale=d ** -0.5, interleaved_kv=interleaved)
    want_dbias = bias is not None
    o, lse = flash_fwd(q, k, v, rr, **kw)
    torch.cuda.synchronize()
    o_ref, l_ref = flash_attention_forward_plain(q, k, v, rr, **kw)
    di = (do.float() * o_ref).sum(-1)
    dq, dbias = flash_dq(q, k, v, do, l_ref, di, rr, want_dbias=want_dbias,
                         **kw)
    dk, dv = flash_dkv(q, k, v, do, l_ref, di, rr, **kw)
    torch.cuda.synchronize()
    dq_ref, dbias_ref = flash_attention_dq_plain(
        q, k, v, do, l_ref, di, rr, want_dbias=want_dbias, **kw)
    dk_ref, dv_ref = flash_attention_dkv_plain(q, k, v, do, l_ref, di, rr,
                                               **kw)
    pairs = {"o": (o, o_ref), "l": (lse, l_ref), "dq": (dq, dq_ref),
             "dk": (dk, dk_ref), "dv": (dv, dv_ref)}
    if want_dbias:
        pairs["dbias"] = (dbias, dbias_ref)
    errs = {}
    for name, (got, want) in pairs.items():
        finite = torch.isfinite(want)
        abs_err = (got.float()[finite] - want.float()[finite]).abs().max()
        errs[name] = (rel_err(got, want), abs_err.item())
    log(f"flash {label} {str(dtype)[6:]}: " + " ".join(
        f"{n} {e[0]:.2e}" for n, e in errs.items()))
    bad = {n: e[0] for n, e in errs.items()
           if not e[0] <= (LSE_TOL if n == "l" else FLASH_TOL)[dtype]}
    if bad:
        raise AssertionError(f"flash {label} {dtype} disagrees: {bad}")
    return errs


def check_flash_all(rng):
    """The train shapes in bf16 and fp32, then the mask zoo at small
    shapes; returns the train-shape bf16 errors and the worst small one."""
    train = {}
    for dtype in (torch.bfloat16, torch.float32):
        train[dtype] = check_flash(rng, "train-shape causal", 4, 16, 4, 2048,
                                   2048, 64, dtype)
    seg = masking.build_segment_ranges(np.repeat(np.arange(6), 50))
    seg[77] = (10, 10)  # an empty row
    block = masking.build_block_sparse_ranges(
        np.tril(np.ones((6, 6), bool)) & ~np.eye(6, k=-3, dtype=bool), 64)
    small = [  # (label, head dim, options); B=2, Hq=8, Hkv=2, S=300
        ("d128", 128, {}),
        ("d256", 256, {}),
        ("window-causal", 64,
         dict(mask=masking.sliding_window(96, causal=True))),
        ("segments-empty-row", 64, dict(
            mask=masking.MaskSpec(masking.MaskKind.SPARSE_RANGES),
            ranges=seg)),
        ("block-sparse", 64, dict(
            mask=masking.MaskSpec(masking.MaskKind.BLOCK_SPARSE,
                                  block_size=64), ranges=block)),
        ("bias-dbias", 64, dict(bias_shape=(1, 8, 300, 300))),
        ("interleaved", 64, dict(interleaved=True)),
    ]
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for label, d, kw in small:
            errs = check_flash(rng, label, 2, 8, 2, 300, 300, d, dtype, **kw)
            worst = max(worst, *(e[0] for e in errs.values()))
        errs = check_flash(rng, "ragged Sq=125 < Skv=1000", 1, 4, 4, 125,
                           1000, 64, dtype)
        worst = max(worst, *(e[0] for e in errs.values()))
    return train, worst


# --------------------------------------------------------------------------
# Phase 4: full-width serving logits vs the fp32 oracle
# --------------------------------------------------------------------------


def rel_l2(x, ref) -> float:
    return ((x.float() - ref).norm() / ref.norm()).item()


GQA_EXECUTOR = types.SimpleNamespace(
    init_cache=init_cache, prefill_chunk=prefill_chunk,
    decode_step=decode_step)
# (forward, attn_fn) of a model family's fp32 oracle: dense attention that
# runs no kernel.
GQA_ORACLE = (forward, plain_attention)
MLA_ORACLE = (mla_forward, plain_mla_attention)


def check_logits(cfg, params, rng, *, params32=None, quantized=False,
                 tol=LOGITS_REL_L2_TOL, label="serving",
                 executor=GQA_EXECUTOR, oracle=GQA_ORACLE):
    """The cached path (``executor``'s calls, as the engine makes them) vs
    the fp32 ``oracle`` on ``params32`` (default: fp32 copies of
    ``params``); ``quantized`` is the pool's ``init_cache`` argument;
    ``tol=None`` reports without a gate."""
    init, prefill, decode = (executor.init_cache, executor.prefill_chunk,
                             executor.decode_step)
    fwd, attn = oracle
    if params32 is None:
        params32 = {
            "embed": params["embed"].float(),
            "unembed": params["unembed"].float(),
            "ln_f": params["ln_f"],
            "layers": [{k: v.float() for k, v in layer.items()}
                       for layer in params["layers"]],
        }
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    pt, chunk, num_pages, max_pages = 256, 256, 16, 8
    cache = init(cfg, num_pages, pt, quantized=quantized, device=DEV)
    seqs = [list(rng.integers(0, cfg.vocab_size, n)) for n in (300, 420)]
    rows = torch.full((2, max_pages), num_pages, dtype=torch.int32)
    rows[0, :3] = torch.tensor([5, 0, 9])
    rows[1, :3] = torch.tensor([2, 11, 7])
    rows = rows.to(DEV)

    def oracle(seq):  # dense fp32 attention: independent of the kernels
        return fwd(params32, torch.tensor([seq], device=DEV), cfg32,
                   attn_fn=attn)[0, -1]

    worst = 0.0
    last = []
    for s, seq in enumerate(seqs):
        for start in range(0, len(seq), chunk):
            part = seq[start: start + chunk]
            padded = torch.zeros(chunk, dtype=torch.long)
            padded[: len(part)] = torch.tensor(part)
            logits, cache = prefill(
                params, padded.to(DEV), start, len(part) - 1, cache,
                rows[s].contiguous(), cfg)
        err = rel_l2(logits, oracle(seq))
        worst = max(worst, err)
        log(f"{label} prefill seq {s} ({len(seq)} tokens): logits rel L2 "
            f"{err:.3e}")
        last.append(int(torch.argmax(logits)))
    for _ in range(8):
        for s in range(2):
            seqs[s].append(last[s])
        tokens = torch.tensor(last, device=DEV)
        lengths = torch.tensor([len(x) for x in seqs], dtype=torch.int32,
                               device=DEV)
        logits, cache = decode(params, tokens, lengths, rows, cache, cfg)
        for s in range(2):
            err = rel_l2(logits[s], oracle(seqs[s]))
            worst = max(worst, err)
        last = torch.argmax(logits, dim=-1).tolist()
    log(f"{label} logits rel L2, worst over prefill + 8 decode steps: "
        f"{worst:.3e} ({'not gated' if tol is None else f'tol {tol}'})")
    if tol is not None and not (np.isfinite(worst) and worst <= tol):
        raise AssertionError(f"{label} logits disagree with the oracle: "
                             f"{worst}")
    return worst


# --------------------------------------------------------------------------
# Phase 5: the engine (the serving path)
# --------------------------------------------------------------------------


def run_engine(cfg, params, seed, quantized_cache=False, label="engine",
               executor=None, layer_gemms=7):
    """Serve the 8 smoke requests; with quantized weights every model call
    must run layers × ``layer_gemms`` + 1 dynamic GEMMs (8 × 7 + 1 for the
    flagship, 8 × 8 + 1 for MLA), and none without."""
    requests = smoke_requests(cfg, seed)
    prompt_lens = [len(r.prompt) for r in requests]
    engine = ServingEngine(params, cfg, quantized_cache=quantized_cache,
                           executor=executor, device=DEV)
    for req in requests:
        engine.submit(req)
    paged_prefill_attention.launches = 0
    paged_decode_attention.launches = 0
    dyn_gemm.launches = 0
    t0 = time.perf_counter()
    outputs = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_prefill": paged_prefill_attention.launches,
                "paged_decode": paged_decode_attention.launches}
    gemms = dyn_gemm.launches
    stats = engine.stats
    for rid in range(len(prompt_lens)):
        toks = outputs[rid]
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{label}: request {rid} did not finish: "
                                 f"{toks}")
    want = {"paged_prefill": cfg.num_layers * stats["prefill_calls"],
            "paged_decode": cfg.num_layers * stats["decode_calls"]}
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    calls = stats["prefill_calls"] + stats["decode_calls"]
    quantized_weights = not isinstance(params["unembed"], torch.Tensor)
    want_gemms = ((layer_gemms * cfg.num_layers + 1) * calls
                  if quantized_weights else 0)
    if gemms != want_gemms:
        raise AssertionError(f"{label}: {gemms} dyn_gemm launches, expected "
                             f"{want_gemms}")
    rates = {
        "prefill_tokens_per_s": stats["prefill_tokens"] / stats["prefill_s"],
        "decode_tokens_per_s": stats["decode_tokens"] / stats["decode_s"],
    }
    log(f"{label} prompts: " + json.dumps(prompt_lens))
    log(f"{label} stats: " + json.dumps(stats))
    log(f"{label} rates: " + json.dumps(rates) + f" wall_s {wall:.3f}")
    log(f"{label} launches: " + json.dumps(launches) + " per model call: "
        + json.dumps({k: v / max(1, stats[c]) for (k, v), c in zip(
            launches.items(), ("prefill_calls", "decode_calls"))})
        + f"; dyn_gemm {gemms} ({gemms / max(1, calls):g} per model call)")
    if quantized_weights:
        launches["dyn_gemm"] = gemms
    return launches, stats, prompt_lens, rates


# --------------------------------------------------------------------------
# Phase 6: full-width fp32 gradients, kernels vs plain attention
# --------------------------------------------------------------------------


def fp32_copy(params):
    return {
        "embed": params["embed"].detach().float(),
        "unembed": params["unembed"].detach().float(),
        "ln_f": params["ln_f"].detach().clone(),
        "layers": [{k: v.detach().float().clone() for k, v in layer.items()}
                   for layer in params["layers"]],
    }


def check_train_grads(cfg, params, rng):
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = fp32_copy(params)
    leaves = trainable_parameters(params32)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 1025))).to(DEV)
    grads, losses = {}, {}
    for name, attn in (("kernels", None), ("plain", plain_attention)):
        for t in leaves:
            t.grad = None
        loss = loss_fn(params32, tokens, cfg32, attn_fn=attn)
        loss.backward()
        grads[name] = [t.grad.detach().clone() for t in leaves]
        losses[name] = loss.item()
    worst = max(rel_l2(g, p) for g, p in zip(grads["kernels"],
                                             grads["plain"]))
    log(f"full-width fp32 grads (B=2, S=1024): loss kernels "
        f"{losses['kernels']:.6f} plain {losses['plain']:.6f}; worst "
        f"parameter rel L2 {worst:.3e} (tol {GRAD_REL_L2_TOL})")
    if not worst <= GRAD_REL_L2_TOL:
        raise AssertionError(f"fp32 gradients disagree: {worst}")
    return worst


# --------------------------------------------------------------------------
# Phase 7: the training path
# --------------------------------------------------------------------------


def run_train(cfg, params, seed):
    tokens = train_tokens(cfg, seed, DEV)  # 4 x 2049: TRAIN_BATCH, TRAIN_SEQ
    optimizer = torch.optim.Adam(trainable_parameters(params), lr=3e-3)
    step = make_train_step(cfg, optimizer)
    state = optimizer.state
    flash_fwd.launches = flash_dq.launches = flash_dkv.launches = 0
    losses, t_first, t0 = [], 0.0, time.perf_counter()
    for i in range(TRAIN_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
        params, state, loss = step(params, state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_fwd.launches, "flash_dq": flash_dq.launches,
                "flash_dkv": flash_dkv.launches}
    losses = [x.item() for x in losses]
    tokens_per_s = (TRAIN_STEPS - 1) * TRAIN_BATCH * TRAIN_SEQ / wall
    log("train losses: " + json.dumps(losses))
    log(f"train: first step {t_first:.3f} s; steps 2-{TRAIN_STEPS} "
        f"{wall:.3f} s, {wall / (TRAIN_STEPS - 1) * 1e3:.1f} ms/step, "
        f"{tokens_per_s:.0f} tokens/s")
    log("train launches: " + json.dumps(launches))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not lower the loss: {losses}")
    want = cfg.num_layers * TRAIN_STEPS
    if any(n != want for n in launches.values()):
        raise AssertionError(f"launch counts {launches}, expected {want} "
                             "each")
    return launches, tokens_per_s


def check_train_determinism(cfg, init, seed, trained):
    """Phase 7's training, from its initial parameters ``init``, run twice
    more (``train_twice``): the two runs equal bit for bit after each step,
    and their final parameters equal phase 7's (``trained``)."""
    rows, final = train_twice(cfg, init, train_tokens(cfg, seed, DEV),
                              TRAIN_STEPS)
    digests = (params_digest(final), params_digest(trained))
    differ = [r for r in rows if r["params_differ"] or r["grads_differ"]
              or r["losses"][0] != r["losses"][1]]
    log(f"train determinism: two runs of {TRAIN_STEPS} steps from phase "
        f"7's initial parameters equal bit for bit after every step: "
        f"{not differ}; their final parameters equal phase 7's: "
        f"{digests[0] == digests[1]} (sha256 {digests[0][:16]})")
    if differ or digests[0] != digests[1]:
        raise AssertionError(f"training is not deterministic: {differ[:2]} "
                             f"{digests}")
    return {"steps": TRAIN_STEPS, "bitwise_equal": True,
            "params_sha256": digests[0]}


# --------------------------------------------------------------------------
# Phase 8: times at the engine's and the train step's shapes
# --------------------------------------------------------------------------


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_by_kernel(fn, iters: int) -> dict:
    """Each CUDA kernel's device time per call of ``fn``, ms, by the
    profiler: ``iters`` calls under it, each kernel's mean time by the
    launches it makes a call (what the events of ``time_ms`` exceed where
    the host's launches are the longer).  The profiler may miss launches
    (one of three ``comp_small_gemm`` launches in this script's runs, also
    after a spin kernel that goes first and is left out), so a kernel's
    launches a call are its traced ones over ``iters``, rounded up: fewer
    than ``iters`` misses of a kernel leave the time whole."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / e.count
            * -(-e.count // iters) / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.key and e.count}


def device_ms(fn, iters: int) -> float:
    """The device time of ``fn``'s kernels per call, ms
    (:func:`device_ms_by_kernel` summed).  Where three traces recorded no
    kernel of ``fn`` at all, :func:`measure_held`'s time (events around a
    train that a spin kernel holds back until it is enqueued), and where
    ``fn`` waits for the card, so that no train can be held, the events'
    time around ``iters`` calls (host time included)."""
    for _ in range(3):
        ms = sum(device_ms_by_kernel(fn, iters).values())
        if ms:
            return ms
    try:
        return measure_held(fn, iters=iters, warmup=0) * 1e3
    except RuntimeError:  # fn synchronizes with the card
        return time_ms(fn, iters, warmup=0)


def kernel_label(key: str) -> str:
    """A profiler kernel name without its return type, namespaces,
    template arguments and parameters."""
    name = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].rsplit("::", 1)[-1]


def device_ms_by_label(fn, iters: int) -> dict:
    """:func:`device_ms_by_kernel` summed by :func:`kernel_label`."""
    out = {}
    for key, ms in device_ms_by_kernel(fn, iters).items():
        out[kernel_label(key)] = out.get(kernel_label(key), 0.0) + ms
    return out


def dense_kv(pool, row, n, pt):
    """One sequence's first n tokens of K and V, [Hkv, n, D]."""
    t = torch.arange(n, device=DEV)
    pidx = row.long()[t // pt]
    return pool[:, pidx, t % pt], pool[:, pidx, pt + t % pt]


def time_decode(rng, lengths, d=64):
    b, hq, hkv, pt, num_pages, max_pages = 8, 16, 4, 256, 256, 16
    lengths = np.asarray(lengths, np.int32)
    pool, table = paged_inputs(rng, lengths, hkv, d, pt, num_pages, max_pages)
    q = torch.from_numpy(rng.standard_normal((b, hq, d), np.float32)).to(
        DEV, torch.bfloat16)
    ln = torch.from_numpy(lengths).to(DEV)
    kernel = lambda: paged_decode_attention(q, pool, table, ln,  # noqa: E731
                                            page_tokens=pt)
    plain = lambda: paged_decode_attention_plain(  # noqa: E731
        q, pool, table, ln, page_tokens=pt)
    s_max = int(lengths.max())
    k = torch.zeros(b, hkv, s_max, d, device=DEV, dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    for i, n in enumerate(lengths):
        k[i, :, :n], v[i, :, :n] = dense_kv(pool, table[i], int(n), pt)
    mask = (torch.arange(s_max, device=DEV)[None, :]
            < ln[:, None].long()).view(b, 1, 1, s_max)
    q4 = q.view(b, hq, 1, d)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k, v, attn_mask=mask, enable_gqa=True)
    times = {"plain_ms": time_ms(plain, 10), "ms": time_ms(kernel, 100),
             "library_ms": time_ms(library, 100)}
    times["plain_ms_2"] = time_ms(plain, 10)
    times["ms_2"] = time_ms(kernel, 100)
    times["device_ms"] = device_ms(kernel, 100)
    times["library_device_ms"] = device_ms(library, 100)
    if d == 64:
        times["device_ms_by_kernel"] = device_ms_by_kernel(kernel, 100)
    if d % 16 == 0:  # the parent's kernels took multiples of 16 only
        parent_turns(f"paged_decode D={d}", times, kernel, 100, device=True)
    live = int(lengths.sum())
    nbytes = (live * hkv * 2 * d * 2  # live K and V, bf16
              + 2 * b * hq * d * 2  # q in, out
              + table.numel() * 4 + b * 4)
    flops = 4 * hq * live * d
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / BF16_FLOPS * 1e3}
    by = max(bound, key=bound.get)
    log(f"decode D={d} times at lengths {lengths.tolist()}: "
        + json.dumps(times)
        + f" bound {bound[by]:.5f} ms by {by}")
    return times, bound[by], by


def time_prefill(rng, offset, d=64):
    hq, hkv, pt, chunk, num_pages, max_pages = 16, 4, 256, 256, 64, 16
    pool, table = paged_inputs(rng, [offset + chunk], hkv, d, pt, num_pages,
                               max_pages)
    row = table[0].contiguous()
    q = torch.from_numpy(rng.standard_normal((hq, chunk, d), np.float32)).to(
        DEV, torch.bfloat16)
    kernel = lambda: paged_prefill_attention(q, pool, row, offset,  # noqa
                                             page_tokens=pt)
    plain = lambda: paged_prefill_attention_plain(  # noqa: E731
        q, pool, row, offset, page_tokens=pt)
    n = offset + chunk
    k, v = dense_kv(pool, row, n, pt)
    mask = (torch.arange(n, device=DEV)[None, :]
            <= offset + torch.arange(chunk, device=DEV)[:, None])
    q4, k4, v4 = q[None], k[None], v[None]
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=mask, enable_gqa=True)
    times = {"plain_ms": time_ms(plain, 10), "ms": time_ms(kernel, 50),
             "library_ms": time_ms(library, 50)}
    times["plain_ms_2"] = time_ms(plain, 10)
    times["ms_2"] = time_ms(kernel, 50)
    times["device_ms"] = device_ms(kernel, 50)
    times["library_device_ms"] = device_ms(library, 50)
    if d % 16 == 0:  # the parent's kernels took multiples of 16 only
        parent_turns(f"paged_prefill offset {offset}"
                     + ("" if d == 64 else f" D={d}"), times, kernel, 50,
                     device=True)
    # What this chunk needs: row c sees offset + c + 1 columns.
    visible = chunk * offset + chunk * (chunk + 1) // 2
    flops = 4 * hq * d * visible
    nbytes = n * hkv * 2 * d * 2 + 2 * hq * chunk * d * 2 + row.numel() * 4
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / BF16_FLOPS * 1e3}
    by = max(bound, key=bound.get)
    log(f"prefill D={d} times at offset {offset}: " + json.dumps(times)
        + f" bound {bound[by]:.5f} ms by {by}")
    return times, bound[by], by


def bound_of(flops: float, nbytes: float):
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / BF16_FLOPS * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by


def time_flash(rng, b=TRAIN_BATCH, hq=16, hkv=4, s=TRAIN_SEQ, d=64):
    """Forward, dQ and dK/dV at the train step's attention shapes (or the
    ones given; bf16, causal), beside their plain versions and SDPA; with
    ``--parent`` also in turns on the parent's kernels where the parent
    builds the width (``mfa_flash_tc_bodies``)."""
    q, k, v, do, _ = flash_inputs(rng, b, hq, hkv, s, s, d, torch.bfloat16)
    rr = row_ranges_tensor(masking.CAUSAL, s, s, None, DEV)
    kw = dict(scale=d ** -0.5)
    o, lse = flash_fwd(q, k, v, rr, **kw)
    di = (do.float() * o).sum(-1)
    bwd_args = (q, k, v, do, lse, di, rr)
    fns = {
        "flash_fwd": (lambda: flash_fwd(q, k, v, rr, **kw),
                      lambda: flash_attention_forward_plain(q, k, v, rr,
                                                            **kw)),
        "flash_dq": (lambda: flash_dq(*bwd_args, **kw),
                     lambda: flash_attention_dq_plain(*bwd_args, **kw)),
        "flash_dkv": (lambda: flash_dkv(*bwd_args, **kw),
                      lambda: flash_attention_dkv_plain(*bwd_args, **kw)),
    }
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                         enable_gqa=True)
    library = {
        "fwd": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20),
        "bwd": time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), 20),
    }
    pairs = b * hq * s * (s + 1) // 2  # (query, key) pairs causal keeps
    elems_q, elems_kv, rows = b * hq * s * d, b * hkv * s * d, b * hq * s
    read_bwd = 2 * (2 * elems_q + 2 * elems_kv) + 2 * 4 * rows + 8 * s
    work = {  # (flops, bytes) from the kernels' GEMM counts and I/O
        "flash_fwd": (4 * d * pairs,
                      2 * (elems_q + 2 * elems_kv) + 8 * s
                      + 4 * (elems_q + rows)),
        "flash_dq": (6 * d * pairs, read_bwd + 4 * elems_q),
        "flash_dkv": (8 * d * pairs, read_bwd + 4 * 2 * elems_kv),
    }
    times = {}
    for name, (kernel, plain) in fns.items():
        t = {"plain_ms": time_ms(plain, 3, warmup=1),
             "ms": time_ms(kernel, 10, warmup=2)}
        t["plain_ms_2"] = time_ms(plain, 3, warmup=0)
        t["ms_2"] = time_ms(kernel, 10, warmup=0)
        t["library_ms"] = library["fwd" if name == "flash_fwd" else "bwd"]
        t["bound_ms"], t["bound_by"] = bound_of(*work[name])
        t["body"] = {"flash_fwd": fwd_body, "flash_dq": dq_body,
                     "flash_dkv": dkv_body}[name](q.dtype, d)
        if name == "flash_fwd":
            t["splits"] = tfa.split_d_fwd_splits(d, b, hq, s, s, sm_count())
        log(f"{name} at D={d} runs the {t['body']} body")
        if d > 256:  # MLA's width: the device ms of each launch
            by = t["device_ms_by_kernel"] = device_ms_by_label(kernel, 10)
            # Where the profiler recorded no launch of the call's own
            # kernel (the merge aside), the held events' time stands in.
            t["device_ms"] = (
                sum(by.values()) if set(by) - {"flash_dkv_merge_kernel"}
                else measure_held(kernel, iters=10, warmup=0) * 1e3)
        if PARENT["lib"] is None or PARENT["lib"].mfa_flash_tc_bodies(
                DTYPE_CODES[q.dtype], d) >= 0:
            parent_turns(f"{name} B={b} S={s} D={d}", t, kernel, 10,
                         by_kernel=d > 256)
        times[name] = t
        log(f"{name} times at B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal "
            "bf16: " + json.dumps(t))
    return times


# --------------------------------------------------------------------------
# Phase 9: the quantized serving slice
# --------------------------------------------------------------------------

W8_CFG = QuantConfig(bits=8, granularity=QuantGranularity.ROW)
W4_CFG = QuantConfig(bits=4, granularity=QuantGranularity.ROW)


def device_generator(rng):
    """A generator on the card seeded from ``rng``: the large inputs of
    phase 9 are drawn there, not on the host."""
    return torch.Generator(device=DEV).manual_seed(int(rng.integers(2**62)))


def gemm_operands(rng, m, n, k, cfg, with_c=False):
    """bf16 activations [M, K] quantized per row, a random weight [N, K]
    quantized with ``cfg``: the kernel's arguments."""
    g = device_generator(rng)
    a = torch.randn((m, k), generator=g, device=DEV).to(torch.bfloat16)
    w = torch.randn((n, k), generator=g, device=DEV)
    wq = quantize(w * k ** -0.5, cfg)
    qa, sa, rs = quantize_rows(a)
    sb, zb = weight_scales(wq)
    c = torch.randn((m, n), generator=g, device=DEV) if with_c else None
    return (qa, wq.data, sa, rs, sb, zb), dict(bits=cfg.bits, c=c)


def check_dyn_gemm(rng):
    """(a) The GEMM kernel against its plain version, bit for bit, at every
    (N, K) of the flagship and of MLAConfig() (N=32 is less than one
    128-column tile), M in {8, 256, 1}, int8 and int4 ROW symmetric
    weights; plus CENTERED ROW, TENSOR and c= cases.  → max abs error."""
    shapes = sorted(set(PROJ_SHAPES.values()) | set(MLA_PROJ_SHAPES.values())
                    | {UNEMBED_SHAPE})
    cases = [(m, n, k, cfg, False) for m in (8, 256, 1) for n, k in shapes
             for cfg in (W8_CFG, W4_CFG)]
    cases += [
        (256, 4096, 1024, QuantConfig(
            bits=8, granularity=QuantGranularity.ROW,
            strategy=QuantStrategy.CENTERED), False),
        (8, 1024, 4096, QuantConfig(bits=8), False),  # TENSOR symmetric
        (256, 1024, 1024, W8_CFG, True),
    ]
    worst = 0.0
    for m, n, k, cfg, with_c in cases:
        args, kw = gemm_operands(rng, m, n, k, cfg, with_c)
        out = dyn_gemm(*args, **kw)
        torch.cuda.synchronize()
        ref = dyn_gemm_plain(*args, **kw)
        err = max_abs(out, ref)
        worst = max(worst, err)
        if not torch.equal(out, ref):
            raise AssertionError(
                f"dyn_gemm M={m} N={n} K={k} {cfg.bits}-bit "
                f"{cfg.granularity.value} {cfg.strategy.value} c={with_c} "
                f"differs from its plain version: max abs {err}")
    log(f"dyn_gemm: {len(cases)} cases (M 8/256/1 x {len(shapes)} shapes x "
        "int8/int4 ROW, CENTERED, TENSOR, c=) bit-identical to the plain "
        f"version (max abs {worst})")
    return worst


def quantized_pool(rng, bits, hkv, d, pt, num_pages):
    """A random int8 pool (int8 halves [.., 2PT, D] or the int4 byte
    [.., PT, D]: every byte value) and per-token scales around 1/127
    (int8) or 1/7 (int4)."""
    rows = pt if bits == 4 else 2 * pt
    g = device_generator(rng)
    pool = torch.randint(-128, 128, (hkv, num_pages + 1, rows, d),
                         generator=g, device=DEV).to(torch.int8)
    step = 7.0 if bits == 4 else 127.0
    ks, vs = ((torch.rand((hkv, num_pages + 1, 1, pt), generator=g,
                          device=DEV) * 1.5 + 0.5) / step for _ in range(2))
    return pool, dict(k_scales=ks, v_scales=vs, kv_bits=bits)


def check_decode_quantized(rng, d, bits):
    b, hq, hkv, pt, num_pages, max_pages = 8, 16, 4, 256, 256, 16
    lengths = np.asarray([1, pt, pt + 1, 1800, 3 * pt + 17, 37, 1024, 4000],
                         np.int32)
    pool, kw = quantized_pool(rng, bits, hkv, d, pt, num_pages)
    table = page_tables(rng, lengths, pt, num_pages, max_pages)
    q = torch.from_numpy(rng.standard_normal((b, hq, d), np.float32)).to(
        DEV, torch.bfloat16)
    ln = torch.from_numpy(lengths).to(DEV)
    out = paged_decode_attention(q, pool, table, ln, page_tokens=pt, **kw)
    torch.cuda.synchronize()
    ref = paged_decode_attention_plain(q, pool, table, ln, page_tokens=pt,
                                       **kw)
    err = max_abs(out, ref)
    log(f"decode int{bits} D={d}: max abs err {err:.3e} (tol {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"paged decode int{bits} D={d} disagrees: {err}")
    return err


def check_prefill_quantized(rng, offset, bits):
    hq, hkv, d, pt, chunk, num_pages, max_pages = 16, 4, 64, 256, 256, 64, 16
    pool, kw = quantized_pool(rng, bits, hkv, d, pt, num_pages)
    row = page_tables(rng, [offset + chunk], pt, num_pages, max_pages)[0]
    q = torch.from_numpy(rng.standard_normal((hq, chunk, d), np.float32)).to(
        DEV, torch.bfloat16)
    out = paged_prefill_attention(q, pool, row, offset, page_tokens=pt, **kw)
    torch.cuda.synchronize()
    ref = paged_prefill_attention_plain(q, pool, row, offset, page_tokens=pt,
                                        **kw)
    err = max_abs(out, ref)
    log(f"prefill int{bits} offset={offset}: max abs err {err:.3e} "
        f"(tol {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"paged prefill int{bits} offset={offset} "
                             f"disagrees: {err}")
    return err


def dequantized_fp32(qparams):
    """The fp32 oracle's weights: each quantized projection dequantized and
    transposed back to [in, out], the float leaves in fp32."""
    def w(t):
        if isinstance(t, QuantizedTensor):
            return dequantize(t).t().contiguous()
        return t.float()

    return {
        "embed": qparams["embed"].float(),
        "unembed": w(qparams["unembed"]),
        "ln_f": qparams["ln_f"],
        "layers": [{k: w(v) for k, v in layer.items()}
                   for layer in qparams["layers"]],
    }


def gemm_bound(m, n, k, bits, with_c=False):
    """(ms, by) of one dynamic GEMM: int8 operations over the int8 peak, or
    its bytes (int8 A, the weight payload, scales and sums, fp32 out) over
    the memory rate."""
    nbytes = (m * k + n * k * bits // 8 + 8 * (m + n) + 4 * m * n
              + (4 * m * n if with_c else 0))
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": 2 * m * n * k / INT8_OPS * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by


def time_dyn_gemm(rng, m, cfg, m_unembed):
    """One model call's 57 GEMMs (8 × the 7 projections at M rows, the
    unembedding at ``m_unembed`` rows: 1 in a prefill chunk, M in decode
    and in the fully quantized forward), each first held to its plain
    version bit for bit: kernel and plain times by CUDA events, the
    kernels' device time (``device_ms``: at M = 8 and 256 the events time
    the host's 57 launches), the summed bound, and two library yardsticks:
    ``torch._int_mm`` on the same int8 operands (M padded to 32 where
    M ≤ 16, as its shape rules ask; int4 weights unpacked to int8 first)
    and ``torch.matmul`` of bf16 activations by the dequantized bf16
    weights.  With ``--parent``, the 57 calls in turns, events and device
    ms."""
    work = [(8, m, n, k) for n, k in PROJ_SHAPES.values()]
    work.append((1, m_unembed, *UNEMBED_SHAPE))
    ops = []
    for count, mm, n, k in work:
        args, kw = gemm_operands(rng, mm, n, k, cfg)
        out = dyn_gemm(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, dyn_gemm_plain(*args, **kw)):
            raise AssertionError(
                f"dyn_gemm M={mm} N={n} K={k} {cfg.bits}-bit differs from "
                "its plain version")
        del out
        qa, qb = args[0], args[1]
        wi8 = unpack_int4(qb) if cfg.bits == 4 else qb
        pad = qa if mm > 16 else torch.cat([qa, qa.new_zeros(32 - mm, k)])
        wb = (wi8.float() * args[4][:, None]).to(torch.bfloat16).t()
        wb = wb.contiguous()
        ab = torch.from_numpy(rng.standard_normal((mm, k), np.float32)).to(
            DEV, torch.bfloat16)
        ops.append((count, args, kw, pad, wi8.t(), ab, wb))

    def run(fn):
        def go():
            for count, *rest in ops:
                for _ in range(count):
                    fn(*rest)
        return go

    kernel = run(lambda args, kw, *_: dyn_gemm(*args, **kw))
    plain = run(lambda args, kw, *_: dyn_gemm_plain(*args, **kw))
    int_mm = run(lambda args, kw, pad, wt, *_: torch._int_mm(pad, wt))
    bf16 = run(lambda args, kw, pad, wt, ab, wb: ab @ wb)
    t = {"plain_ms": time_ms(plain, 2, warmup=1), "ms": time_ms(kernel, 10),
         "library_ms": time_ms(int_mm, 10),
         "library_bf16_matmul_ms": time_ms(bf16, 10)}
    t["plain_ms_2"] = time_ms(plain, 2, warmup=0)
    t["ms_2"] = time_ms(kernel, 10)
    t["device_ms"] = device_ms(kernel, 10)
    t["library_device_ms"] = device_ms(int_mm, 10)
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    t["tiles"] = {f"{mm}x{n}x{k}": dyn_tile(mm, n, k, sms)
                  for _, mm, n, k in work}
    parent_turns(f"dyn_gemm W{cfg.bits}A8 57 GEMMs at M={m}", t, kernel, 10,
                 device=True)
    bounds = [(count, gemm_bound(mm, n, k, cfg.bits))
              for count, mm, n, k in work]
    t["bound_ms"] = sum(count * b for count, (b, _) in bounds)
    by_bytes = sum(count * b for count, (b, by) in bounds if by == "bytes")
    t["bound_by"] = ("bytes" if by_bytes >= t["bound_ms"] / 2
                     else "operations")
    log(f"dyn_gemm W{cfg.bits}A8 times, one model call at M={m} (57 "
        "launches): " + json.dumps(t))
    return t


def dense_kv_quantized(pool, kw, row, n, pt):
    """One sequence's first n tokens of K and V dequantized to bf16."""
    t = torch.arange(n, device=DEV)
    pidx, off = row.long()[t // pt], t % pt
    if kw["kv_bits"] == 4:
        k, v = unpack_kv4(pool[:, pidx, off])
    else:
        k, v = pool[:, pidx, off], pool[:, pidx, pt + off]
    ks = kw["k_scales"][:, :, 0][:, pidx, off]
    vs = kw["v_scales"][:, :, 0][:, pidx, off]
    return ((k.float() * ks[..., None]).to(torch.bfloat16),
            (v.float() * vs[..., None]).to(torch.bfloat16))


def kv_token_bytes(bits, hkv, d):
    """Live cache bytes per token: K and V payloads and two fp32 scales
    per KV head."""
    return hkv * (2 * d * bits // 8 + 8)


def time_decode_quantized(rng, lengths, bits, d=64):
    b, hq, hkv, pt, num_pages, max_pages = 8, 16, 4, 256, 256, 16
    lengths = np.asarray(lengths, np.int32)
    pool, kw = quantized_pool(rng, bits, hkv, d, pt, num_pages)
    table = page_tables(rng, lengths, pt, num_pages, max_pages)
    q = torch.from_numpy(rng.standard_normal((b, hq, d), np.float32)).to(
        DEV, torch.bfloat16)
    ln = torch.from_numpy(lengths).to(DEV)
    kernel = lambda: paged_decode_attention(  # noqa: E731
        q, pool, table, ln, page_tokens=pt, **kw)
    plain = lambda: paged_decode_attention_plain(  # noqa: E731
        q, pool, table, ln, page_tokens=pt, **kw)
    s_max = int(lengths.max())
    k = torch.zeros(b, hkv, s_max, d, device=DEV, dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    for i, n in enumerate(lengths):
        k[i, :, :n], v[i, :, :n] = dense_kv_quantized(pool, kw, table[i],
                                                      int(n), pt)
    mask = (torch.arange(s_max, device=DEV)[None, :]
            < ln[:, None].long()).view(b, 1, 1, s_max)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q.view(b, hq, 1, d), k, v, attn_mask=mask, enable_gqa=True)
    times = {"plain_ms": time_ms(plain, 10), "ms": time_ms(kernel, 100),
             "library_ms": time_ms(library, 100)}
    times["ms_2"] = time_ms(kernel, 100)
    times["device_ms"] = device_ms(kernel, 100)
    times["library_device_ms"] = device_ms(library, 100)
    parent_turns(f"paged_decode int{bits} D={d}", times, kernel, 100,
                 device=True)
    live = int(lengths.sum())
    nbytes = (live * kv_token_bytes(bits, hkv, d) + 2 * b * hq * d * 2
              + table.numel() * 4 + b * 4)
    times["bound_ms"], times["bound_by"] = bound_of(4 * hq * live * d,
                                                    nbytes)
    log(f"decode int{bits} D={d} times at lengths {lengths.tolist()}: "
        + json.dumps(times))
    return times


def time_prefill_quantized(rng, offset, bits):
    hq, hkv, d, pt, chunk, num_pages, max_pages = 16, 4, 64, 256, 256, 64, 16
    pool, kw = quantized_pool(rng, bits, hkv, d, pt, num_pages)
    row = page_tables(rng, [offset + chunk], pt, num_pages, max_pages)[0]
    q = torch.from_numpy(rng.standard_normal((hq, chunk, d), np.float32)).to(
        DEV, torch.bfloat16)
    kernel = lambda: paged_prefill_attention(  # noqa: E731
        q, pool, row, offset, page_tokens=pt, **kw)
    plain = lambda: paged_prefill_attention_plain(  # noqa: E731
        q, pool, row, offset, page_tokens=pt, **kw)
    n = offset + chunk
    k, v = dense_kv_quantized(pool, kw, row, n, pt)
    mask = (torch.arange(n, device=DEV)[None, :]
            <= offset + torch.arange(chunk, device=DEV)[:, None])
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[None], k[None], v[None], attn_mask=mask, enable_gqa=True)
    times = {"plain_ms": time_ms(plain, 10), "ms": time_ms(kernel, 50),
             "library_ms": time_ms(library, 50)}
    times["ms_2"] = time_ms(kernel, 50)
    times["device_ms"] = device_ms(kernel, 50)
    times["library_device_ms"] = device_ms(library, 50)
    parent_turns(f"paged_prefill int{bits} offset {offset}", times, kernel,
                 50, device=True)
    visible = chunk * offset + chunk * (chunk + 1) // 2
    nbytes = (n * kv_token_bytes(bits, hkv, d) + 2 * hq * chunk * d * 2
              + row.numel() * 4)
    times["bound_ms"], times["bound_by"] = bound_of(4 * hq * d * visible,
                                                    nbytes)
    log(f"prefill int{bits} times at offset {offset}: " + json.dumps(times))
    return times


def quantized_logits_at_init(cfg, params, seed):
    """Phase 9 (c) on the random-init weights, reported without a gate
    (run before phase 7 trains ``params`` in place).  Their logits are
    nearly flat, so the int4 pool's noise weighs far more in the relative
    L2 than it does on the trained weights that (c) gates."""
    out = {}
    with torch.inference_mode():
        for bits, wcfg in ((8, W8_CFG), (4, W4_CFG)):
            qparams = quantize_weights(params, wcfg)
            out[f"w{bits}a8+int{bits}"] = check_logits(
                cfg, qparams, np.random.default_rng(seed + 2),
                params32=dequantized_fp32(qparams), quantized=bits,
                tol=None, label=f"random-init w{bits}a8+int{bits}")
            del qparams
    return out


def run_quantized(cfg, params, seed, rng, dec_lens):
    """Phase 9 (a)-(e) → the record's quantized fields.  ``params`` are the
    flagship's weights after phase 7's 8 Adam steps.  The logits checks
    draw their token sequences from a generator of their own (seed + 2),
    so they see the same tokens whatever the kernel checks draw."""
    out = {"errors": {}, "logits_rel_l2": {}, "engines": {}, "times": {}}
    phase = {}
    t = time.perf_counter()
    with torch.inference_mode():
        out["errors"]["dyn_gemm"] = check_dyn_gemm(rng)
        for bits in (8, 4):
            out["errors"][f"decode_int{bits}"] = max(
                check_decode_quantized(rng, d, bits) for d in (64, 128))
            out["errors"][f"prefill_int{bits}"] = max(
                check_prefill_quantized(rng, off, bits)
                for off in (0, 300, 512))
    phase["quant_kernels"] = time.perf_counter() - t
    for bits, wcfg in ((8, W8_CFG), (4, W4_CFG)):
        label = f"w{bits}a8+int{bits}"
        t = time.perf_counter()
        with torch.inference_mode():
            qparams = quantize_weights(params, wcfg)
            out["logits_rel_l2"][label] = check_logits(
                cfg, qparams, np.random.default_rng(seed + 2),
                params32=dequantized_fp32(qparams),
                quantized=bits, tol=QUANT_LOGITS_TOL[bits], label=label)
        phase[f"logits_{label}"] = time.perf_counter() - t
        t = time.perf_counter()
        launches, stats, _, rates = run_engine(
            cfg, qparams, seed, quantized_cache=bits, label=f"engine {label}")
        out["engines"][label] = {"launches": launches, "rates": rates,
                                 "model_calls": stats["prefill_calls"]
                                 + stats["decode_calls"]}
        phase[f"engine_{label}"] = time.perf_counter() - t
        del qparams
    t = time.perf_counter()
    with torch.inference_mode():
        for bits, wcfg in ((8, W8_CFG), (4, W4_CFG)):
            # decode, a prefill chunk (its logits: the last token's), the
            # fully quantized forward (2 × 2048 tokens, every token's)
            for m, m_unembed in ((8, 8), (256, 1), (QFWD_M, QFWD_M)):
                out["times"][f"dyn_gemm_w{bits}_m{m}"] = time_dyn_gemm(
                    rng, m, wcfg, m_unembed)
            out["times"][f"decode_int{bits}"] = time_decode_quantized(
                rng, dec_lens, bits)
            out["times"][f"prefill_int{bits}"] = time_prefill_quantized(
                rng, 512, bits)
    phase["quant_times"] = time.perf_counter() - t
    return out, phase

# --------------------------------------------------------------------------
# Phase 10: the quantized-attention slice
# --------------------------------------------------------------------------

# The flagship's attention shapes (B=2 sequences of 2048 tokens).
ATTN_B, ATTN_HQ, ATTN_HKV, ATTN_S, ATTN_D = 2, 16, 4, 2048, 64
QFWD_TOKENS = (2, 2048)  # the fully quantized forward's batch
QFWD_M = QFWD_TOKENS[0] * QFWD_TOKENS[1]  # its GEMMs' rows
# The fully quantized forward and the facade vs their fp32 oracles,
# relative L2: the int8 gate (weights, activations, Q and K/V in int8),
# the JAX facade test's 0.05, and the int4 gate.
QFWD_LOGITS_TOL = TOLERANCES["int8_rel"]
FACADE_TOL = {8: 0.05, 4: TOLERANCES["int4_rel"]}


def qcfg(bits=8, gran="row", strategy="symmetric", **kw):
    return QuantConfig(bits=bits, granularity=QuantGranularity(gran),
                       strategy=QuantStrategy(strategy), **kw)


def attn_inputs(rng, b, hq, hkv, sq, skv, d, dtype=torch.bfloat16):
    """bf16 Q and K/V (the float K/V as the model makes them) drawn on the
    card."""
    g = device_generator(rng)
    return tuple(torch.randn(shape, generator=g, device=DEV).to(dtype)
                 for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                               (b, hkv, skv, d)))


def check_pair(label, kernel, plain, dtype=torch.bfloat16):
    """A kernel's (O, L) against its plain version's → (rel err of O, rel
    err of L, max abs err of O); raises past the flash kernels' gates for
    ``dtype`` (bf16 where P is rounded)."""
    (o, lse), (o_ref, l_ref) = kernel, plain
    errs = (rel_err(o, o_ref), rel_err(lse, l_ref), max_abs(o, o_ref))
    log(f"{label}: o {errs[0]:.2e} l {errs[1]:.2e} (max abs {errs[2]:.2e})")
    if not (errs[0] <= FLASH_TOL[dtype] and errs[1] <= LSE_TOL[dtype]):
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{errs}")
    return errs


def main_path_tile(kw, skv, block_sizes=BlockSizes()):
    """The key span ``quantized_flash_attention_forward`` hands the kernel:
    the TPU's resolved ``block_kv`` where P is int8, else None (the
    kernel's 64-key tiles)."""
    return int8_p_tile(block_sizes, skv) if kw["mode"].p_int8 else None


def same_bits(label, first, second):
    """Raises unless two calls' outputs (a tensor or a tuple, None skipped)
    are equal bit for bit."""
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    if not all(torch.equal(a, b) for a, b in zip(first, second)
               if a is not None):
        raise AssertionError(f"{label}: two calls differ")


def check_qattn(rng, label, b, hq, hkv, sq, skv, d, kcfg, vcfg,
                mask=masking.CAUSAL, bias_shape=None, dtype=torch.bfloat16,
                block_kv=None, repeat=False, **opts):
    """The quantized forward against its plain version over the main
    path's key spans (the TPU's ``block_kv`` where P is int8), at the fp32
    gate for an fp32 Q whose P is not int8; ``repeat``: called twice, the
    same bits required → check_pair's errors."""
    q, k, v = attn_inputs(rng, b, hq, hkv, sq, skv, d, dtype)
    if bias_shape is not None:
        opts["bias"] = torch.randn(bias_shape, device=DEV,
                                   generator=device_generator(rng))
    args, kw = qattn_arguments(q, quantize(k.float(), kcfg),
                               quantize(v.float(), vcfg), mask=mask, **opts)
    tile = main_path_tile(kw, skv, BlockSizes(block_kv=block_kv)
                          if block_kv else BlockSizes())
    out = qattn_fwd(*args, **kw, kv_tile=tile)
    if repeat:
        same_bits(f"qattn_fwd {label}", out,
                  qattn_fwd(*args, **kw, kv_tile=tile))
    torch.cuda.synchronize()
    exact = dtype == torch.float32 and not kw["mode"].p_int8
    return check_pair(f"qattn_fwd {label} "
                      f"({qattn_body(args[0].dtype, kw['mode'], d=d)})", out,
                      qattn_fwd_plain(*args, **kw, kv_tile=tile or KV_TILE),
                      torch.float32 if exact else torch.bfloat16)


def check_qattn_all(rng):
    """(a) The quantized forward kernel in each mode: the flagship shapes,
    then small ones.  → {label: errors}."""
    shapes = (ATTN_B, ATTN_HQ, ATTN_HKV, ATTN_S, ATTN_S, ATTN_D)
    row8, row8c, row4c = qcfg(), qcfg(strategy="centered"), qcfg(
        bits=4, strategy="centered")
    ten8, ch8 = qcfg(gran="tensor"), qcfg(gran="channel")
    b2d = qcfg(gran="block_2d", strategy="centered", block_rows=4,
               block_size=32)
    b2d48 = qcfg(gran="block_2d", strategy="centered", block_rows=4,
                 block_size=48)
    errs = {
        "quantize_q_row": check_qattn(rng, "quantize_q ROW (flagship)",
                                      *shapes, row8, row8, quantize_q=True),
        "dequant_row8c": check_qattn(rng, "dequant ROW CENTERED int8 "
                                     "(flagship)", *shapes, row8c, row8c),
        "dequant_row4c": check_qattn(rng, "dequant ROW CENTERED int4 "
                                     "(flagship)", *shapes, row4c, row4c),
        "folded_tensor": check_qattn(rng, "folded TENSOR (flagship)",
                                     *shapes, ten8, ten8),
        "folded_row": check_qattn(rng, "folded ROW (flagship)", *shapes,
                                  row8, row8),
    }
    small = (2, 8, 2, 300, 300)
    cases = [  # (label, head dim, K, V, options)
        ("int8_pv CHANNEL V", 64, row8, ch8, dict(quantize_q=True)),
        ("int8_pv TENSOR V", 64, ten8, ten8, dict(quantize_q=True)),
        ("BLOCK_2D", 64, b2d, b2d, {}),
        ("bias", 64, row8c, row8c, dict(bias_shape=(1, 8, 300, 300))),
        ("window-causal", 64, row8c, row8c,
         dict(mask=masking.sliding_window(96, causal=True))),
        ("interleaved", 64, row8c, row8c, dict(interleaved_kv=True)),
        ("d128", 128, row8c, row8c, {}),
        # Head dims run zero-padded to the next built width.
        ("quantize_q d80", 80, row8, row8, dict(quantize_q=True)),
        ("int4 ROW CENTERED d96", 96, row4c, row4c, {}),
        ("folded CHANNEL d96", 96, ch8, ch8, {}),
        ("BLOCK_2D 48 d96", 96, b2d48, b2d48, {}),
    ]
    for label, d, kcfg, vcfg, opts in cases:
        errs[label] = check_qattn(rng, label, *small, d, kcfg, vcfg, **opts)
    errs["ragged"] = check_qattn(rng, "ragged Sq=125 < Skv=1000", 1, 4, 4,
                                 125, 1000, 64, row8c, row8c)
    return errs


def check_hpack_all(rng):
    """(b) The head-pair kernel at the flagship shapes in the packed
    layout, int8 and int4 CHANNEL scales, causal and full."""
    errs = {}
    for bits in (8, 4):
        cfg = qcfg(bits=bits, gran="channel")
        for mask, name in ((masking.CAUSAL, "causal"), (masking.FULL, "full")):
            q, k, v = attn_inputs(rng, ATTN_B, ATTN_HQ, ATTN_HKV, ATTN_S,
                                  ATTN_S, ATTN_D)
            args, kw = hpack_arguments(pack_heads(q), quantize(k.float(), cfg),
                                       quantize(v.float(), cfg), mask=mask)
            out = hpack_fwd(*args, **kw)
            torch.cuda.synchronize()
            errs[f"int{bits}_{name}"] = check_pair(
                f"hpack_fwd int{bits} {name} (flagship, packed)", out,
                hpack_fwd_plain(*args, **kw))
    return errs


# Runtime quantization's shapes past the main path's (rows [R, K]; blocks
# [R, K] and bs): ragged and unaligned widths, a slab whose rows do not
# divide over its cluster or number fewer than its CTAs, bs 32 and 256, a
# band past the CTA's held chunks; the offset puts the base off 16-byte
# alignment.
RTQ_ROW_SHAPES = [((50, 37), 0), ((64, 96), 0), ((33, 100), 0),
                  ((300, 64), 1), ((9, 2000), 0)]
RTQ_BLOCK_SHAPES = [((300, 384), 128, 0), ((300, 256), 32, 0),
                    ((200, 1024), 256, 0), ((5, 256), 64, 0),
                    ((40, 300), 100, 0), ((64, 512), 64, 1),
                    ((20000, 64), 64, 0)]


def rtq_input(g, shape, dtype, offset=0):
    """x [R, K] of ``dtype`` drawn on the card, ``offset`` elements into
    its storage."""
    n = shape[0] * shape[1]
    flat = torch.randn(n + offset, generator=g, device=DEV) * 2 + 0.3
    return flat.to(dtype)[offset:].view(shape)


def check_runtime_quantization(rng):
    """(c) Both runtime quantization kernels against their plain versions,
    bit for bit (codes, scales, zero points, Σq), each called twice on the
    same input with the same bits: the row kernel on the facade's K/V rows
    ([2·4·2048, 64]) and the block kernel on a [4096, 1024] activation at
    bs 64 and 128, in every strategy at 8 and 4 bits in bf16 and fp32;
    then the same over RTQ_ROW_SHAPES and RTQ_BLOCK_SHAPES.  → the number
    of cases compared."""
    g = device_generator(rng)
    inputs = [("row", rtq_input(g, (ATTN_B * ATTN_HKV * ATTN_S, ATTN_D), dt),
               None) for dt in (torch.bfloat16, torch.float32)]
    inputs += [("block", rtq_input(g, (4096, 1024), dt), bs)
               for dt in (torch.bfloat16, torch.float32) for bs in (64, 128)]
    inputs += [("row", rtq_input(g, shape, dt, off), None)
               for shape, off in RTQ_ROW_SHAPES
               for dt in (torch.bfloat16, torch.float32)]
    inputs += [("block", rtq_input(g, shape, dt, off), bs)
               for shape, bs, off in RTQ_BLOCK_SHAPES
               for dt in (torch.bfloat16, torch.float32)]
    cases = 0
    for kind, x, bs in inputs:
        for strategy in QuantStrategy:
            for bits in (8, 4):
                if kind == "row":
                    call = lambda: rtq.rtq_rows(  # noqa: E731
                        x, strategy, bits, True)
                    want = rtq.rtq_rows_plain(x, strategy, bits, True)
                else:
                    call = lambda: rtq.rtq_blocks(  # noqa: E731
                        x, bs, strategy, bits, True)
                    want = rtq.rtq_blocks_plain(x, bs, strategy, bits, True)
                first = call()
                second = call()
                torch.cuda.synchronize()
                for name, a, b, w in zip(("codes", "scale", "zero point",
                                          "sums"), first, second, want):
                    if not (torch.equal(a, w) and torch.equal(b, w)):
                        raise AssertionError(
                            f"runtime quantization {kind} {list(x.shape)} "
                            f"{x.dtype} {strategy.value} int{bits} bs={bs}:"
                            f" {name} differs from the plain version or "
                            "between two calls")
                cases += 1
    log(f"runtime quantization: {cases} cases (rows [16384, 64] and blocks "
        "[4096, 1024] bs 64 / 128, then the ragged shapes; 3 strategies x "
        "int8/int4 x bf16/fp32) bit-identical to the plain versions, twice")
    return cases


def run_quantized_attention_forward(cfg, qparams, seed, packed, tol, label):
    """(d) ``quantized_forward(..., quantize_kv=True)`` on QFWD_TOKENS
    tokens with the launch counts set to 0 just before and read after, against
    the fp32 ``forward`` on the dequantized weights (plain attention, no
    kernel); ``tol=None`` reports without a gate."""
    tokens = torch.from_numpy(np.random.default_rng(seed + 3).integers(
        0, cfg.vocab_size, QFWD_TOKENS)).to(DEV)
    qattn_fwd.launches = hpack_fwd.launches = dyn_gemm.launches = 0
    t0 = time.perf_counter()
    logits = quantized_forward(qparams, tokens, cfg, quantize_kv=True,
                               packed_d64=None if packed else False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"qattn_fwd": qattn_fwd.launches,
                "hpack_fwd": hpack_fwd.launches,
                "dyn_gemm": dyn_gemm.launches}
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref = forward(dequantized_fp32(qparams), tokens, cfg32,
                  attn_fn=plain_attention)
    err = rel_l2(logits, ref)
    finite = bool(torch.isfinite(logits).all())
    del ref
    log(f"{label}: logits rel L2 {err:.3e} "
        f"({'not gated' if tol is None else f'tol {tol}'}), "
        f"{wall:.3f} s, launches " + json.dumps(launches))
    want = {"qattn_fwd": 0 if packed else cfg.num_layers,
            "hpack_fwd": cfg.num_layers if packed else 0,
            "dyn_gemm": 7 * cfg.num_layers + 1}
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches}, expected "
                             f"{want}")
    if tuple(logits.shape) != (*QFWD_TOKENS, cfg.vocab_size) or not finite:
        raise AssertionError(f"{label}: logits {tuple(logits.shape)}, "
                             f"finite {finite}")
    if tol is not None and not err <= tol:
        raise AssertionError(f"{label}: logits disagree with the oracle: "
                             f"{err}")
    return err, launches


def run_quantized_attention_forwards(cfg, params, seed, tol, tag):
    """(d) packed (auto) and unpacked, W8A8 weights of ``params``."""
    out = {}
    with torch.inference_mode():
        qparams = quantize_weights(params, W8_CFG)
        for packed in (True, False):
            name = "packed" if packed else "unpacked"
            out[name] = run_quantized_attention_forward(
                cfg, qparams, seed, packed, tol,
                f"{tag} quantized_forward(quantize_kv=True) {name}")
        del qparams
    return out


def run_facade(rng):
    """(e) ``QuantizedAttention`` at the flagship attention shapes, int8
    CENTERED and int4 with the Hadamard rotation, causal, against the dense
    fp32 attention over the float K/V, with the launch counts set to 0
    just before each call and read after."""
    q, k, v = attn_inputs(rng, ATTN_B, ATTN_HQ, ATTN_HKV, ATTN_S, ATTN_S,
                          ATTN_D)
    ref = reference_attention(q.float(), k.float(), v.float(),
                              mask=masking.CAUSAL)[0]
    out = {}
    for bits, hadamard in ((8, False), (4, True)):
        facade = QuantizedAttention(
            config=QuantizedAttentionConfig(key_bits=bits, value_bits=bits,
                                            hadamard=hadamard),
            mask=masking.CAUSAL)
        rtq.rtq_rows.launches = qattn_fwd.launches = 0
        with torch.inference_mode():
            o = facade(q, k, v)
        torch.cuda.synchronize()
        launches = {"runtime_quantize_row": rtq.rtq_rows.launches,
                    "qattn_fwd": qattn_fwd.launches}
        err = rel_l2(o, ref)
        label = f"QuantizedAttention int{bits}" + (" hadamard" if hadamard
                                                   else " CENTERED")
        log(f"{label}: O rel L2 {err:.3e} (tol {FACADE_TOL[bits]}), "
            "launches " + json.dumps(launches))
        if launches != {"runtime_quantize_row": 2, "qattn_fwd": 1}:
            raise AssertionError(f"{label}: launch counts {launches}")
        if o.shape != q.shape or not err <= FACADE_TOL[bits]:
            raise AssertionError(f"{label}: O rel L2 {err}")
        out[f"int{bits}"] = (err, launches)
    return out


def run_block_quantizer(rng):
    """The block kernel's entry point: ``runtime_quantize`` of a [4096,
    1024] bf16 activation with the blockwise-centered configuration at bs
    64 and 128, the launch count set to 0 just before and read after."""
    act = torch.randn((4096, 1024), generator=device_generator(rng),
                      device=DEV).to(torch.bfloat16)
    rtq.rtq_blocks.launches = 0
    for bs in (64, 128):
        t = rtq.runtime_quantize(act, int8_blockwise(bs))
        if tuple(t.data.shape) != (4096, 1024) or t.scale.shape != (
                1, 1024 // bs):
            raise AssertionError(f"runtime_quantize bs={bs}: shapes "
                                 f"{tuple(t.data.shape)} {tuple(t.scale.shape)}")
    torch.cuda.synchronize()
    launches = rtq.rtq_blocks.launches
    log(f"runtime_quantize(int8_blockwise(64 | 128)) on [4096, 1024]: "
        f"{launches} block-kernel launches")
    if launches != 2:
        raise AssertionError(f"block kernel launches {launches}, expected 2")
    return launches


def attn_bound(pairs, ops_int8, ops_bf16, nbytes):
    """(ms, by): bytes over the memory rate, or int8 and bf16 products over
    their peaks, whichever is larger."""
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": (ops_int8 * pairs / INT8_OPS
                            + ops_bf16 * pairs / BF16_FLOPS) * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by


def dequantized_bf16(t):
    return dequantize(t).to(torch.bfloat16)


def time_quantized_attention(rng):
    """(f) Kernel, plain and library times of the four kernels at the
    shapes above: the quantized forward in the unpacked model's mode
    (quantize_q, ROW K/V) and in the facade's (ROW CENTERED), the
    head-pair kernel in the packed model's (CHANNEL, causal), the row
    kernel on the facade's K/V rows and the block kernel on a [4096, 1024]
    activation at bs 64 and 128 (both quantizers also by device time), and
    one facade call (:func:`time_facade`).  Library: SDPA over the
    dequantized bf16 K/V for attention; none for runtime quantization."""
    b, hq, hkv, s, d = ATTN_B, ATTN_HQ, ATTN_HKV, ATTN_S, ATTN_D
    pairs = b * hq * s * (s + 1) // 2
    q, k, v = attn_inputs(rng, b, hq, hkv, s, s, d)
    out_bytes = 4 * b * hq * s * d + 4 * b * hq * s + 8 * s  # O, L, ranges
    kv_bytes = 2 * b * hkv * s * d  # int8 K and V payloads
    times = {}

    def timed(name, kernel, plain, library, bound, extra=None, device=False):
        t = {"plain_ms": time_ms(plain, 2, warmup=1),
             "ms": time_ms(kernel, 10, warmup=2)}
        t["plain_ms_2"] = time_ms(plain, 2, warmup=0)
        t["ms_2"] = time_ms(kernel, 10, warmup=0)
        if device:  # events time the host's dispatch of a short kernel
            t["device_ms"] = device_ms(kernel, 10)
            t["device_ms_2"] = device_ms(kernel, 10)
        t["library_ms"] = None if library is None else time_ms(library, 10)
        parent_turns(name, t, kernel, 10, device=device)
        t["bound_ms"], t["bound_by"] = bound
        t.update(extra or {})
        log(f"{name} times: " + json.dumps(t))
        return t

    def sdpa(kq, vq):
        kd, vd = dequantized_bf16(kq), dequantized_bf16(vq)
        return lambda: F.scaled_dot_product_attention(
            q, kd, vd, is_causal=True, enable_gqa=True)

    row8, row8c = qcfg(), qcfg(strategy="centered")
    kq, vq = quantize(k.float(), row8), quantize(v.float(), row8)
    args, kw = qattn_arguments(q, kq, vq, mask=masking.CAUSAL,
                               quantize_q=True)
    tile = main_path_tile(kw, s)
    body = qattn_body(args[0].dtype, kw["mode"])
    log(f"qattn_fwd quantize_q ROW runs the {body} body")
    times["qattn_fwd"] = timed(
        "qattn_fwd quantize_q ROW (B=2 Hq=16 Hkv=4 S=2048 D=64 causal)",
        lambda: qattn_fwd(*args, **kw, kv_tile=tile),
        lambda: qattn_fwd_plain(*args, **kw, kv_tile=tile),
        sdpa(kq, vq),
        attn_bound(pairs, 2 * d, 2 * d,
                   b * hq * s * d + 4 * b * hq * s + kv_bytes
                   + 12 * b * hkv * s + out_bytes), {"body": body})
    kq, vq = quantize(k.float(), row8c), quantize(v.float(), row8c)
    args, kw = qattn_arguments(q, kq, vq, mask=masking.CAUSAL)
    log("qattn_fwd dequant ROW CENTERED runs the "
        f"{qattn_body(args[0].dtype, kw['mode'])} body")
    facade_t = timed(
        "qattn_fwd dequant ROW CENTERED (the facade's mode)",
        lambda: qattn_fwd(*args, **kw), lambda: qattn_fwd_plain(*args, **kw),
        sdpa(kq, vq),
        attn_bound(pairs, 0, 4 * d, 2 * b * hq * s * d + kv_bytes
                   + 16 * b * hkv * s + out_bytes))
    times["qattn_fwd"].update({f"{key}_facade_mode": facade_t[key] for key in
                               ("ms", "plain_ms", "library_ms", "bound_ms",
                                "parent_turns_ms") if key in facade_t})
    ch8 = qcfg(gran="channel")
    kq, vq = quantize(k.float(), ch8), quantize(v.float(), ch8)
    args, kw = hpack_arguments(pack_heads(q), kq, vq, mask=masking.CAUSAL)
    body = qattn_body(args[0].dtype, QAttnMode("none", "store"), packed=True)
    log(f"hpack_fwd ({args[0].dtype} packed Q) runs the {body} body")
    times["hpack_fwd"] = timed(
        "hpack_fwd int8 CHANNEL causal (packed, the packed model's mode)",
        lambda: hpack_fwd(*args, **kw), lambda: hpack_fwd_plain(*args, **kw),
        sdpa(kq, vq),
        attn_bound(pairs, 0, 4 * d, 2 * b * hq * s * d + kv_bytes
                   + 4 * b * hkv * d + out_bytes), {"body": body})
    g = device_generator(rng)
    rows = torch.randn((b * hkv * s, d), generator=g, device=DEV).to(
        torch.bfloat16)
    centered = QuantStrategy.CENTERED
    times["runtime_quantize_row"] = timed(
        "runtime_quantize_row CENTERED [16384, 64] bf16",
        lambda: rtq.rtq_rows(rows, centered, 8),
        lambda: rtq.rtq_rows_plain(rows, centered, 8, False), None,
        bound_of(0, 3 * rows.numel() + 8 * rows.shape[0]), device=True)
    act = torch.randn((4096, 1024), generator=g, device=DEV).to(
        torch.bfloat16)
    times["runtime_quantize_block"] = timed(
        "runtime_quantize_block CENTERED [4096, 1024] bf16 bs 64",
        lambda: rtq.rtq_blocks(act, 64, centered, 8, True),
        lambda: rtq.rtq_blocks_plain(act, 64, centered, 8, True), None,
        bound_of(0, 3 * act.numel() + 12 * 16), device=True)
    bs128 = timed(
        "runtime_quantize_block CENTERED [4096, 1024] bf16 bs 128",
        lambda: rtq.rtq_blocks(act, 128, centered, 8, True),
        lambda: rtq.rtq_blocks_plain(act, 128, centered, 8, True), None,
        bound_of(0, 3 * act.numel() + 12 * 8), device=True)
    times["runtime_quantize_block"].update(
        {f"{key}_bs128": bs128[key] for key in (
            "ms", "device_ms", "plain_ms", "bound_ms",
            "parent_turns_device_ms") if key in bs128})
    times["facade"] = time_facade(q, k, v)
    return times


def time_facade(q, k, v):
    """(f) One ``QuantizedAttention`` int8 CENTERED call (phase 10 (e)'s
    shape, causal): events, and device ms by kernel (its two row
    quantizers and one ``qattn_fwd``), in turns with ``--parent``."""
    facade = QuantizedAttention(
        config=QuantizedAttentionConfig(key_bits=8, value_bits=8,
                                        hadamard=False),
        mask=masking.CAUSAL)
    call = lambda: facade(q, k, v)  # noqa: E731
    t = {"ms": time_ms(call, 10), "ms_2": time_ms(call, 10, warmup=0)}
    t["device_ms_by_kernel"] = device_ms_by_label(call, 10)
    t["device_ms"] = (sum(t["device_ms_by_kernel"].values())
                      or measure_held(call, iters=10, warmup=0) * 1e3)
    parent_turns("QuantizedAttention int8 CENTERED call (B=2 Hq=16 Hkv=4 "
                 "S=2048 D=64 causal)", t, call, 10, by_kernel=True)
    log("QuantizedAttention int8 CENTERED call times: " + json.dumps(t))
    return t


def run_quantized_attention(cfg, params, seed, rng):
    """Phase 10 (a)-(f) except the random-init logits → its record."""
    out, phase = {}, {}
    t = time.perf_counter()
    with torch.inference_mode():
        out["qattn_errors"] = check_qattn_all(rng)
        out["hpack_errors"] = check_hpack_all(rng)
        out["rtq_cases"] = check_runtime_quantization(rng)
    phase["qattn_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    out["forward"] = run_quantized_attention_forwards(
        cfg, params, seed, QFWD_LOGITS_TOL, "trained")
    phase["qattn_forward"] = time.perf_counter() - t
    t = time.perf_counter()
    out["facade"] = run_facade(rng)
    out["block_launches"] = run_block_quantizer(rng)
    with torch.inference_mode():
        out["times"] = time_quantized_attention(rng)
    phase["qattn_facade_times"] = time.perf_counter() - t
    return out, phase

# --------------------------------------------------------------------------
# Phase 11: the quantized backward
# --------------------------------------------------------------------------

# The JAX package's north-star arm (bench.py's B=4, H=4, S=4096, D=256,
# FULL, int8 ROW K / CHANNEL V, its block sizes), as utils/profiling.py
# defines it.
NS_B, NS_H, NS_S, NS_D = NORTH_STAR_SHAPE
NS_BLOCKS = NORTH_STAR_BLOCKS
# Relative L2 per gradient: full-integer vs exact is the JAX package's gate
# (tests/test_quantized_attention.py:781, 840); the exact call and QAT vs
# the fp32 dense VJP on the dequantized K/V, and the facade's dq, the int8
# gate (test_quantized_attention.py:208).
QBWD_TOL = 0.05
BWD_KERNELS = (fbwd.qflash_dq, fbwd.qflash_dkv, fbwd.fullint_dq,
               fbwd.fullint_dkv, qattn_fwd, rtq.rtq_rows)


def reset_bwd_counts():
    for fn in BWD_KERNELS:
        fn.launches = 0


def bwd_counts():
    return {fn.__name__: fn.launches for fn in BWD_KERNELS if fn.launches}


def bwd_inputs(q, kq, vq, g, mask=masking.FULL, **opts):
    """(dO, L, D) of the quantized forward over (q, K, V); dO drawn on the
    card from ``g``."""
    o, lse = quantized_flash_attention_forward(q, kq, vq, mask=mask, **opts)
    do = torch.randn(q.shape, generator=g, device=DEV).to(q.dtype)
    return do, lse, (do.float() * o).sum(-1)


def check_bwd_pair(label, got, want, names, dtype=torch.bfloat16):
    """Kernel outputs against the plain versions' → {name: (rel err, max
    abs err)}; raises past the flash kernels' gate for ``dtype`` on the
    rel err."""
    errs = {n: (rel_err(g, w), max_abs(g, w))
            for n, g, w in zip(names, got, want) if w is not None}
    log(f"{label}: " + " ".join(f"{n} {e[0]:.2e}" for n, e in errs.items()))
    if not all(e[0] <= FLASH_TOL[dtype] for e in errs.values()):
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{errs}")
    return errs


def check_qflash(rng, label, b, hq, hkv, sq, skv, d, kcfg, vcfg,
                 mask=masking.CAUSAL, bias_shape=None, dtype=torch.bfloat16,
                 repeat=False, **opts):
    """K1/K2 (the exact quantized dQ, dK/dV) against their plain versions
    in the mode the JAX package's selection gives these configurations, at
    the gate of Q's ``dtype``; ``repeat``: called twice, the same bits
    required."""
    q, k, v = attn_inputs(rng, b, hq, hkv, sq, skv, d, dtype)
    kq, vq = quantize(k.float(), kcfg), quantize(v.float(), vcfg)
    g = device_generator(rng)
    bias = (None if bias_shape is None
            else torch.randn(bias_shape, generator=g, device=DEV))
    do, lse, di = bwd_inputs(q, kq, vq, g, mask=mask, bias=bias, **opts)
    rr = row_ranges_tensor(mask, sq, skv, None, DEV)
    (dq_a, dq_kw), (dkv_a, dkv_kw) = fbwd.qflash_arguments(
        q, kq, vq, do, lse, di, rr, bias, scale=d ** -0.5,
        want_dbias=bias is not None, **opts)

    def call():
        return (*fbwd.qflash_dq(*dq_a, **dq_kw),
                *fbwd.qflash_dkv(*dkv_a, **dkv_kw))

    got = call()
    if repeat:
        same_bits(f"qflash {label}", got, call())
    torch.cuda.synchronize()
    want = (*fbwd.qflash_dq_plain(*dq_a, **dq_kw),
            *fbwd.qflash_dkv_plain(*dkv_a, **dkv_kw))
    return check_bwd_pair(f"qflash {label} ({dq_kw['mode'].k}/"
                          f"{dkv_kw['mode'].k} K, {dq_body(dtype, d)})", got,
                          want, ("dq", "dbias", "dk", "dv"), dtype)


def check_fullint(rng, label, b, hq, hkv, s, d, kcfg, vcfg, level2,
                  block_sizes=NS_BLOCKS, repeat=False):
    """K3/K4 (the full-integer dQ, dK/dV) against their plain versions;
    level 2 quantizes over ``block_sizes``' spans (bench.py's: 512 keys,
    1024 queries); ``repeat``: called twice, the same bits required."""
    q, k, v = attn_inputs(rng, b, hq, hkv, s, s, d)
    kq, vq = quantize(k.float(), kcfg), quantize(v.float(), vcfg)
    do, lse, di = bwd_inputs(q, kq, vq, device_generator(rng),
                             quantize_q=True)
    (dq_a, dq_kw), (dkv_a, dkv_kw) = fbwd.fullint_arguments(
        q, kq, vq, None, lse, do, scale=d ** -0.5, block_sizes=block_sizes,
        di=di, int8_grads=level2)

    def call():
        return (fbwd.fullint_dq(*dq_a, **dq_kw),
                *fbwd.fullint_dkv(*dkv_a, **dkv_kw))

    name = (f"fullint {label} level {2 if level2 else 1} (widths "
            f"{dq_kw['width']}/{dkv_kw['width']}, "
            f"{fullint_body(d, dq_kw['width'])})")
    got = call()
    if repeat:
        same_bits(name, got, call())
    torch.cuda.synchronize()
    want = (fbwd.fullint_dq_plain(*dq_a, **dq_kw),
            *fbwd.fullint_dkv_plain(*dkv_a, **dkv_kw))
    return check_bwd_pair(name, got, want, ("dq", "dk", "dv"))


def check_bwd_kernels_all(rng):
    """(a) K3/K4 at the north-star shape (levels 1 and 2, ROW and TENSOR K),
    K1/K2 at the flagship's attention shapes in five modes, then small
    shapes.  → {label: errors}."""
    ns = (NS_B, NS_H, NS_H, NS_S, NS_D)
    row8, row8c, row4c = qcfg(), qcfg(strategy="centered"), qcfg(
        bits=4, strategy="centered")
    ten8, ch8 = qcfg(gran="tensor"), qcfg(gran="channel")
    errs = {}
    for level2 in (False, True):
        lv = 2 if level2 else 1
        errs[f"fullint_row_l{lv}"] = check_fullint(
            rng, "ROW K / CHANNEL V (north-star)", *ns, row8, ch8, level2)
        errs[f"fullint_tensor_l{lv}"] = check_fullint(
            rng, "TENSOR K / TENSOR V (north-star)", *ns, ten8, ten8, level2)
    flagship = (ATTN_B, ATTN_HQ, ATTN_HKV, ATTN_S, ATTN_S, ATTN_D)
    for name, kcfg, vcfg in (("folded_row", row8, row8),
                             ("folded_channel", ch8, ch8),
                             ("folded_tensor", ten8, ten8),
                             ("dequant_row8c", row8c, row8c),
                             ("dequant_row4c", row4c, row4c)):
        errs[name] = check_qflash(rng, f"{name} (flagship)", *flagship,
                                  kcfg, vcfg)
    b2d = qcfg(gran="block_2d", strategy="centered", block_rows=4,
               block_size=32)
    b2d48 = qcfg(gran="block_2d", strategy="centered", block_rows=4,
                 block_size=48)
    small = (2, 8, 2, 300, 300)
    for label, d, kcfg, vcfg, opts in (
            ("BLOCK_2D", 64, b2d, b2d, {}),
            ("bias-dbias", 64, row8c, row8c,
             dict(bias_shape=(1, 8, 300, 300))),
            ("window-causal", 64, row8c, row8c,
             dict(mask=masking.sliding_window(96, causal=True))),
            ("interleaved", 64, row8c, row8c, dict(interleaved_kv=True)),
            ("folded CHANNEL interleaved", 64, ch8, ch8,
             dict(interleaved_kv=True)),
            ("d128", 128, row8c, row8c, {}),
            ("d256 folded ROW", 256, row8, row8, {}),
            # Head dims run zero-padded to the next built width.
            ("d80", 80, row8c, row8c, {}),
            ("d96 int4", 96, row4c, row4c, {}),
            ("d96 folded ROW", 96, row8, row8, {}),
            ("BLOCK_2D 48 d96", 96, b2d48, b2d48, {})):
        errs[label] = check_qflash(rng, label, *small, d, kcfg, vcfg, **opts)
    for d in (80, 96):
        errs[f"fullint_d{d}_l1"] = check_fullint(
            rng, f"ROW K / CHANNEL V D={d}", 2, 4, 4, 512, d, row8, ch8, False)
    # S=200 resolves to 8-wide level-2 spans: the scalar kernels' widths.
    errs["fullint_w8_l2"] = check_fullint(
        rng, "ROW K / CHANNEL V S=200 (scalar widths)", 1, 4, 4, 200, 64,
        row8, ch8, True)
    errs["ragged"] = check_qflash(rng, "ragged Sq=125 < Skv=1000", 1, 4, 4,
                                  125, 1000, 64, row8c, row8c)
    return errs


def bench_grads(q, kq, vq, do, fullint):
    """bench.py's gradients (``north_star_grads``), the launch counts set to
    0 just before and read after → (grads, launches, s)."""
    reset_bwd_counts()
    t0 = time.perf_counter()
    grads = north_star_grads(q, kq, vq, do, fullint)
    torch.cuda.synchronize()
    return grads, bwd_counts(), time.perf_counter() - t0


def dense_grads(q, kq, vq, do, mask=masking.FULL):
    """The fp32 dense VJP (dq, dk, dv) on the dequantized K/V, one batch
    element at a time."""
    kd, vd = dequantize(kq), dequantize(vq)
    parts = [reference_attention_vjp(q[i:i + 1].float(), kd[i:i + 1],
                                     vd[i:i + 1], do[i:i + 1].float(),
                                     mask=mask)
             for i in range(q.shape[0])]
    return [torch.cat(p) for p in zip(*parts)]


def gate_grads(label, got, want, names):
    errs = {n: rel_l2(g, w) for n, g, w in zip(names, got, want)}
    log(f"{label}: rel L2 " + json.dumps(errs) + f" (tol {QBWD_TOL})")
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    shapes = all(g.shape == w.shape for g, w in zip(got, want))
    if not (finite and shapes and all(e <= QBWD_TOL for e in errs.values())):
        raise AssertionError(f"{label}: {errs}, finite {finite}, shapes "
                             f"{shapes}")
    return errs


def run_north_star(rng):
    """(b) The full-width fwd+bwd, full-integer and exact, gated against
    each other and the exact one against the dense VJP."""
    q, kq, vq, do = north_star_inputs(device_generator(rng))
    names = ("dq", "dk_scale", "dv_scale")
    full, full_launches, full_s = bench_grads(q, kq, vq, do, True)
    exact, exact_launches, exact_s = bench_grads(q, kq, vq, do, False)
    log(f"north-star fwd+bwd (B={NS_B} H={NS_H} S={NS_S} D={NS_D} FULL): "
        f"full-integer {full_s:.3f} s, launches {json.dumps(full_launches)};"
        f" exact {exact_s:.3f} s, launches {json.dumps(exact_launches)}")
    if full_launches != {"qattn_fwd": 1, "fullint_dq": 1, "fullint_dkv": 1}:
        raise AssertionError(f"full-integer launches {full_launches}")
    if exact_launches != {"qattn_fwd": 1, "qflash_dq": 1, "qflash_dkv": 1}:
        raise AssertionError(f"exact launches {exact_launches}")
    out = {"fullint_vs_exact": gate_grads(
        "north-star full-integer vs exact", full, exact, names)}
    dq, dk, dv = dense_grads(q, kq, vq, do)
    dense = (dq, tqa._scale_zp_cotangents(dk, kq)[0],
             tqa._scale_zp_cotangents(dv, vq)[0])
    out["exact_vs_dense"] = gate_grads(
        "north-star exact vs fp32 dense VJP on the dequantized K/V", exact,
        dense, names)
    out["fullint_vs_dense_not_gated"] = {
        n: rel_l2(g, w) for n, g, w in zip(names, full, dense)}
    out["launches"] = {"fullint": full_launches, "exact": exact_launches}
    out["seconds"] = {"fullint": full_s, "exact": exact_s}
    return out, (q, kq, vq, do)


def run_qat(rng):
    """(c) ``quantized_flash_attention_qat`` (int8 ROW CENTERED, causal) at
    the flagship's attention shapes against the dense VJP on the
    dequantized K/V, and the ``QuantizedAttention`` gradient with respect
    to q; launch counts set to 0 just before each call and read after."""
    q, k, v = attn_inputs(rng, ATTN_B, ATTN_HQ, ATTN_HKV, ATTN_S, ATTN_S,
                          ATTN_D)
    do = torch.randn(q.shape, generator=device_generator(rng),
                     device=DEV).to(torch.bfloat16)
    cfg = qcfg(strategy="centered")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_bwd_counts()
    o = quantized_flash_attention_qat(*leaves, cfg, masking.CAUSAL)
    grads = torch.autograd.grad((o.float() * do.float()).sum(), leaves)
    torch.cuda.synchronize()
    qat_launches = bwd_counts()
    want = {"qattn_fwd": 1, "qflash_dq": 1, "qflash_dkv": 1}
    if qat_launches != want:
        raise AssertionError(f"QAT launches {qat_launches}, expected {want}")
    dense = dense_grads(q, quantize(k.float(), cfg), quantize(v.float(), cfg),
                        do, masking.CAUSAL)
    out = {"qat": gate_grads("QAT int8 ROW CENTERED (flagship, causal)",
                             grads, dense, ("dq", "dk", "dv"))}
    facade = QuantizedAttention(mask=masking.CAUSAL)
    qg = q.clone().requires_grad_(True)
    reset_bwd_counts()
    of = facade(qg, k, v)
    (dq,) = torch.autograd.grad((of.float() * do.float()).sum(), [qg])
    torch.cuda.synchronize()
    facade_launches = bwd_counts()
    want = {"rtq_rows": 2, "qattn_fwd": 1, "qflash_dq": 1, "qflash_dkv": 1}
    if facade_launches != want:
        raise AssertionError(f"facade launches {facade_launches}, expected "
                             f"{want}")
    kq, vq = facade.quantize_kv(k, v)
    out["facade"] = gate_grads(
        "QuantizedAttention dq (int8 CENTERED, flagship, causal)", [dq],
        dense_grads(q, kq, vq, do, masking.CAUSAL)[:1], ("dq",))
    out["launches"] = {"qat": qat_launches, "facade": facade_launches}
    return out, (q, k, v, do)


def check_north_star_kernels(q, kq, vq, do):
    """The main path's kernels against their plain versions on its own
    north-star inputs, in the modes it launches them: the quantized
    forward with int8 Q and int8 P (D=256), the full-integer dQ / dK/dV
    (level 1, ROW K / CHANNEL V) and the exact ones (folded ROW K /
    CHANNEL V) → ({name: errors}, the kernels' arguments)."""
    d = q.shape[-1]
    f_args, f_kw = qattn_arguments(q, kq, vq, quantize_q=True)
    f_kw["kv_tile"] = main_path_tile(f_kw, q.shape[2], NS_BLOCKS)
    o, lse = qattn_fwd(*f_args, **f_kw)
    torch.cuda.synchronize()
    errs = {"qattn_fwd": check_pair(
        f"qattn_fwd int8 Q / int8 P D=256 over {f_kw['kv_tile']}-key spans "
        "(north-star)", (o, lse), qattn_fwd_plain(*f_args, **f_kw))}
    # Not gated: the one-pass softmax rounds the int8 P against each row's
    # final max, where the kernel (as the TPU's) rounds against the running
    # one over block_kv spans; over 4096 keys that moves O by ~0.1 of its
    # max abs.
    o_1, l_1 = qattn_fwd_plain(*f_args, **{**f_kw, "kv_tile": None})
    errs["qattn_fwd_one_pass"] = (rel_err(o, o_1), rel_err(lse, l_1),
                                  max_abs(o, o_1))
    log("qattn_fwd vs the one-pass plain version (not gated): o "
        f"{errs['qattn_fwd_one_pass'][0]:.2e} l "
        f"{errs['qattn_fwd_one_pass'][1]:.2e}")
    del o_1, l_1
    di = (do.float() * o).sum(-1)
    (f_dq, f_dq_kw), (f_dkv, f_dkv_kw) = fbwd.fullint_arguments(
        q, kq, vq, None, lse, do, scale=d ** -0.5, block_sizes=NS_BLOCKS,
        di=di)
    rr = row_ranges_tensor(masking.FULL, q.shape[2], q.shape[2], None, DEV)
    (e_dq, e_dq_kw), (e_dkv, e_dkv_kw) = fbwd.qflash_arguments(
        q, kq, vq, do, lse, di, rr, scale=d ** -0.5)
    args = {"qattn_fwd": (f_args, f_kw), "fullint_dq": (f_dq, f_dq_kw),
            "fullint_dkv": (f_dkv, f_dkv_kw), "qflash_dq": (e_dq, e_dq_kw),
            "qflash_dkv": (e_dkv, e_dkv_kw)}
    for name, outs, mode in (
            ("fullint_dq", ("dq",), "level 1, ROW K / CHANNEL V"),
            ("fullint_dkv", ("dk", "dv"), "level 1, ROW K / CHANNEL V"),
            ("qflash_dq", ("dq", "dbias"), f"{e_dq_kw['mode'].k} K"),
            ("qflash_dkv", ("dk", "dv"), f"{e_dkv_kw['mode'].k} K")):
        a, kw = args[name]
        got = getattr(fbwd, name)(*a, **kw)
        torch.cuda.synchronize()
        want = getattr(fbwd, f"{name}_plain")(*a, **kw)
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        errs[name] = check_bwd_pair(f"{name} {mode} (north-star)", got,
                                    want, outs)
    return errs, args


def time_quantized_backward(ns_args, qat_inputs):
    """(d) K1-K4 times beside their bounds, plain versions and the SDPA
    backward over the dequantized bf16 K/V (dq, dk, dv together; a
    yardstick): K3/K4 at the north-star shape (level 1, the main path's),
    K1/K2 there in the exact arm's mode (folded ROW K / CHANNEL V) and at
    the flagship's attention shapes in QAT's (dequant ROW CENTERED); the
    quantized forward in the north-star's mode beside SDPA."""
    (q, kq, vq, do), args = ns_args
    b, h, s, d = q.shape
    pairs = b * h * s * s
    n_q, n_kv, rows = b * h * s * d, b * h * s * d, b * h * s
    (f_dq, f_dq_kw), (f_dkv, f_dkv_kw) = args["fullint_dq"], args[
        "fullint_dkv"]
    (e_dq, e_dq_kw), (e_dkv, e_dkv_kw) = args["qflash_dq"], args[
        "qflash_dkv"]
    fwd_a, fwd_kw = args["qattn_fwd"]

    def sdpa_bwd(q_, kd, vd, do_, causal):
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q_, kd, vd))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                             enable_gqa=True)
        return lambda: torch.autograd.grad(out, (qg, kg, vg), do_,
                                           retain_graph=True)

    def timed(name, kernel, plain, library, bound):
        t = {"plain_ms": time_ms(plain, 2, warmup=1),
             "ms": time_ms(kernel, 5, warmup=1)}
        t["plain_ms_2"] = time_ms(plain, 2, warmup=0)
        t["ms_2"] = time_ms(kernel, 5, warmup=0)
        t["library_ms"] = time_ms(library, 5, warmup=1)
        parent_turns(name, t, kernel, 5)
        t["bound_ms"], t["bound_by"] = bound
        log(f"{name} times: " + json.dumps(t))
        return t

    kd, vd = dequantized_bf16(kq), dequantized_bf16(vq)
    lib = sdpa_bwd(q, kd, vd, do, False)
    stats = 4 * rows  # one fp32 [B, H, S] vector
    int8_in = 2 * n_q + 2 * n_kv  # Q and dO (one copy), K and V payloads
    times = {
        "fullint_dq": timed(
            "fullint_dq level 1 ROW K (north-star)",
            lambda: fbwd.fullint_dq(*f_dq, **f_dq_kw),
            lambda: fbwd.fullint_dq_plain(*f_dq, **f_dq_kw), lib,
            attn_bound(pairs, 4 * d, 2 * d, int8_in + 4 * stats
                       + 4 * b * h * s + 4 * n_q)),
        "fullint_dkv": timed(
            "fullint_dkv level 1 ROW K (north-star)",
            lambda: fbwd.fullint_dkv(*f_dkv, **f_dkv_kw),
            lambda: fbwd.fullint_dkv_plain(*f_dkv, **f_dkv_kw), lib,
            attn_bound(pairs, 4 * d, 4 * d, int8_in + n_q + 5 * stats
                       + 4 * b * h * s + 8 * n_kv)),
        "qflash_dq": timed(
            "qflash_dq folded ROW K / CHANNEL V (north-star, the exact arm)",
            lambda: fbwd.qflash_dq(*e_dq, **e_dq_kw),
            lambda: fbwd.qflash_dq_plain(*e_dq, **e_dq_kw), lib,
            attn_bound(pairs, 0, 6 * d, 4 * n_q + 2 * n_kv + 3 * stats
                       + 4 * b * h * d + 4 * n_q + 8 * s)),
        "qflash_dkv": timed(
            "qflash_dkv token K / channel V (north-star, the exact arm)",
            lambda: fbwd.qflash_dkv(*e_dkv, **e_dkv_kw),
            lambda: fbwd.qflash_dkv_plain(*e_dkv, **e_dkv_kw), lib,
            attn_bound(pairs, 0, 8 * d, 4 * n_q + 2 * n_kv + 4 * stats
                       + 4 * b * h * d + 8 * n_kv + 8 * s)),
        # int8 Q with its scales, K with its per-token scales, V with its
        # per-channel ones in; O and L out; int8 QK and int8 PV products.
        "qattn_fwd": timed(
            "qattn_fwd int8 Q / int8 P D=256 (north-star)",
            lambda: qattn_fwd(*fwd_a, **fwd_kw),
            lambda: qattn_fwd_plain(*fwd_a, **fwd_kw),
            lambda: F.scaled_dot_product_attention(q, kd, vd),
            attn_bound(pairs, 4 * d, 0, n_q + stats + 2 * n_kv
                       + 4 * b * h * s + 4 * b * h * d + 4 * n_q + stats
                       + 8 * s)),
    }
    for name, body in (("qflash_dq", dq_body), ("qflash_dkv", dkv_body)):
        times[name]["body"] = body(e_dkv[0].dtype, d)
        log(f"{name} at the north-star (D={d}) runs the "
            f"{times[name]['body']} body")
    # K3/K4 at level 2 on the same inputs: dS (P^T, dS^T) row-quantized
    # over bench.py's 512-key (1024-query) spans, every product int8.
    lse, di = f_dq[7], f_dq[8]  # fullint_dq's L (-inf as 0) and D
    (l2_dq, l2_dq_kw), (l2_dkv, l2_dkv_kw) = fbwd.fullint_arguments(
        q, kq, vq, None, lse, do, scale=d ** -0.5, block_sizes=NS_BLOCKS,
        di=di, int8_grads=True)
    for name, kernel, plain, a, kw, ops, nbytes in (
            ("fullint_dq", fbwd.fullint_dq, fbwd.fullint_dq_plain, l2_dq,
             l2_dq_kw, 6 * d, int8_in + 4 * stats + 4 * b * h * s + 4 * n_q),
            ("fullint_dkv", fbwd.fullint_dkv, fbwd.fullint_dkv_plain,
             l2_dkv, l2_dkv_kw, 8 * d,
             int8_in + n_q + 5 * stats + 4 * b * h * s + 8 * n_kv)):
        t = timed(f"{name} level 2 ROW K, width {kw['width']} (north-star)",
                  lambda: kernel(*a, **kw), lambda: plain(*a, **kw), lib,
                  attn_bound(pairs, ops, 0, nbytes))
        times[name].update({f"{key}_level2": t[key] for key in (
            "ms", "ms_2", "plain_ms", "bound_ms", "bound_by",
            "parent_turns_ms") if key in t})
        times[name]["width_level2"] = kw["width"]
        times[name]["body"] = fullint_body(d, 0)
        times[name]["body_level2"] = fullint_body(d, kw["width"])
        log(f"{name} at the north-star (D={d}) runs the "
            f"{times[name]['body']} body at level 1, the "
            f"{times[name]['body_level2']} body at level 2")
    del lib, kd, vd, args, f_dq, f_dkv, e_dq, e_dkv, fwd_a, l2_dq, l2_dkv
    # K1/K2 in QAT's mode at the flagship's attention shapes (causal).
    q, k, v, do = qat_inputs
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    cfg = qcfg(strategy="centered")
    kq, vq = quantize(k.float(), cfg), quantize(v.float(), cfg)
    o, lse = quantized_flash_attention_forward(q, kq, vq,
                                               mask=masking.CAUSAL)
    di = (do.float() * o).sum(-1)
    rr = row_ranges_tensor(masking.CAUSAL, s, s, None, DEV)
    (e_dq, e_dq_kw), (e_dkv, e_dkv_kw) = fbwd.qflash_arguments(
        q, kq, vq, do, lse, di, rr, scale=d ** -0.5)
    lib = sdpa_bwd(q, dequantized_bf16(kq), dequantized_bf16(vq), do, True)
    pairs = b * hq * s * (s + 1) // 2
    n_q, n_kv, stats = b * hq * s * d, b * hkv * s * d, 4 * b * hq * s
    for name, kernel, plain, ops, out_bytes in (
            ("qflash_dq", fbwd.qflash_dq, fbwd.qflash_dq_plain, 6 * d,
             4 * n_q + 4 * b * hkv * d),
            ("qflash_dkv", fbwd.qflash_dkv, fbwd.qflash_dkv_plain, 8 * d,
             8 * n_kv)):
        a, kw = (e_dq, e_dq_kw) if name == "qflash_dq" else (e_dkv, e_dkv_kw)
        t = timed(f"{name} dequant ROW CENTERED (flagship, causal: QAT's "
                  "mode)", lambda: kernel(*a, **kw), lambda: plain(*a, **kw),
                  lib, attn_bound(pairs, 0, ops, 4 * n_q + 2 * n_kv
                                  + 16 * b * hkv * s + 2 * stats + out_bytes
                                  + 8 * s))
        times[name].update({f"{key}_qat_mode": t[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms")})
    for name, body in (("qflash_dq", dq_body), ("qflash_dkv", dkv_body)):
        times[name]["body_qat_mode"] = body(e_dkv[0].dtype, d)
        log(f"{name} in QAT's mode (D={d}) runs the "
            f"{times[name]['body_qat_mode']} body")
    return times


def run_quantized_backward(seed):
    """Phase 11 (a)-(d), inputs from a fourth generator (seed + 3) →
    (record, phase seconds)."""
    rng = np.random.default_rng(seed + 3)
    out, phase = {}, {}
    t = time.perf_counter()
    with torch.inference_mode():
        out["errors"] = check_bwd_kernels_all(rng)
    phase["qbwd_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    out["north_star"], ns_inputs = run_north_star(rng)
    phase["qbwd_north_star"] = time.perf_counter() - t
    t = time.perf_counter()
    out["qat"], qat_inputs = run_qat(rng)
    phase["qbwd_qat"] = time.perf_counter() - t
    t = time.perf_counter()
    with torch.no_grad():
        out["north_star_errors"], ns_args = check_north_star_kernels(
            *ns_inputs)
    phase["qbwd_north_star_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    out["times"] = time_quantized_backward((ns_inputs, ns_args), qat_inputs)
    phase["qbwd_times"] = time.perf_counter() - t
    return out, phase

# --------------------------------------------------------------------------
# Phase 12: MLA serving and the weight-only GEMM
# --------------------------------------------------------------------------

# MLAConfig()'s latent attention: 16 query heads over one head-shared
# latent state of d_c + d_r = 256 + 32 lanes, V's rope tail of 32 zeroed,
# softmax scale (dh + d_r)^-0.5 (models/cached_mla.py).
MLA_HQ, MLA_D, MLA_VTZ = 16, 288, 32
MLA_SCALE = (64 + 32) ** -0.5
# The decompression (mla_decompress at B=2, S=2048): GEMMs of M = B·S
# latent rows, N = H·dh = 16·64, K = d_c = 256.
DEC_B, DEC_S, DEC_H, DEC_DH, DEC_DC = 2, 2048, 16, 64, 256
# The weight-only GEMM kernels vs their plain versions on the same
# arguments, fp32 results: the same products (exact for bf16 × int8 and
# bf16 × bf16) summed in another order.  Max abs over the plain's max abs.
WO_TOL = TOLERANCES["fp32"]
# The decompression path vs the absorbed path on the dequantized weights,
# relative L2: bf16 K/V against bf16 absorbed queries.
DECOMPRESS_TOL = TOLERANCES["mixed"]
# The absorbed attention over a per-token int8 latent vs the fp32 dense
# attention on the dequantized latent, relative L2: tests/test_mla.py's
# int8 gate.
ABSORBED_INT8_TOL = TOLERANCES["int8_rel"] / 5
# (label, weight config, A dtype): the folded kernel's modes, then the
# dequant-on-load kernel's.
WO_CASES = (
    ("folded int8 ROW", WEIGHT_CFG, torch.bfloat16),
    ("folded int4 ROW", QuantConfig(bits=4, granularity=QuantGranularity.ROW),
     torch.bfloat16),
    ("folded int8 TENSOR", QuantConfig(bits=8), torch.bfloat16),
    ("wo int8 BLOCK 128", int8_blockwise(128), torch.bfloat16),
    ("wo int8 ASYMMETRIC ROW", QuantConfig(
        bits=8, granularity=QuantGranularity.ROW,
        strategy=QuantStrategy.ASYMMETRIC), torch.bfloat16),
    ("wo int8 ROW fp32 A", WEIGHT_CFG, torch.float32),
)


def mla_pool(rng, quantized, num_pages, pt, d=MLA_D):
    """A latent pool [1, NP+1, PT, d] (one state per token): bf16
    states, or int8 ones with one scale per token for K and V."""
    g = device_generator(rng)
    shape = (1, num_pages + 1, pt, d)
    if not quantized:
        pool = torch.randn(shape, generator=g, device=DEV)
        return pool.to(torch.bfloat16), {}
    pool = torch.randint(-128, 128, shape, generator=g, device=DEV)
    sc = (torch.rand((1, num_pages + 1, 1, pt), generator=g, device=DEV)
          * 1.5 + 0.5) / 127
    return pool.to(torch.int8), dict(k_scales=sc, v_scales=sc)


def mla_gate(label, out, ref):
    """A paged kernel's output at MLA's geometry against its plain
    version's → (rel err, max abs err); raises past the bf16 gate or if
    the rope tail of the output is not zero."""
    errs = (rel_err(out, ref), max_abs(out, ref))
    tail = out[..., MLA_D - MLA_VTZ:].float().abs().max().item()
    log(f"{label}: rel {errs[0]:.2e} max abs {errs[1]:.2e} (tol "
        f"{FLASH_TOL[torch.bfloat16]}), rope-tail max {tail}")
    if not (errs[0] <= FLASH_TOL[torch.bfloat16] and tail == 0.0):
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{errs}, tail {tail}")
    return errs


def check_mla_paged(rng):
    """(a) Both paged kernels at MLA's geometry (Hq=16 over Hkv=1, D=288,
    one-state pages, v_tail_zero=32) with bf16 and int8 pools: decode at
    phase 2's lengths, prefill of a 256-token chunk at three offsets.
    → {label: (rel err, max abs err)}."""
    pt, num_pages, max_pages, chunk = 256, 256, 16, 256
    lengths = np.asarray([1, pt, pt + 1, 1800, 3 * pt + 17, 37, 1024, 4000],
                         np.int32)
    errs = {}
    for quantized in (False, True):
        kind = "int8" if quantized else "bf16"
        pool, kw = mla_pool(rng, quantized, num_pages, pt)
        kw.update(page_tokens=pt, v_tail_zero=MLA_VTZ, scale=MLA_SCALE)
        table = page_tables(rng, lengths, pt, num_pages, max_pages)
        q = torch.from_numpy(rng.standard_normal(
            (len(lengths), MLA_HQ, MLA_D), np.float32)).to(DEV, torch.bfloat16)
        ln = torch.from_numpy(lengths).to(DEV)
        out = paged_decode_attention(q, pool, table, ln, **kw)
        torch.cuda.synchronize()
        errs[f"decode_{kind}"] = mla_gate(
            f"paged_decode MLA {kind} pool", out,
            paged_decode_attention_plain(q, pool, table, ln, **kw))
        for offset in (0, 300, 512):
            row = page_tables(rng, [offset + chunk], pt, num_pages,
                              max_pages)[0]
            q = torch.from_numpy(rng.standard_normal(
                (MLA_HQ, chunk, MLA_D), np.float32)).to(DEV, torch.bfloat16)
            out = paged_prefill_attention(q, pool, row, offset, **kw)
            torch.cuda.synchronize()
            errs[f"prefill_{kind}_{offset}"] = mla_gate(
                f"paged_prefill MLA {kind} pool offset={offset}", out,
                paged_prefill_attention_plain(q, pool, row, offset, **kw))
    return errs


def check_mla_flash(rng):
    """(b) The flash forward, dQ and dK/dV kernels at MLA's latent head
    dims: D=80 (tests/test_mla_serving.py's d_c + d_r) and D=288
    (MLAConfig()'s), 16 query heads over one KV head, bf16 and fp32 at
    S=300, and D=288 bf16 at mla_forward's B=2, S=2048.  → {label:
    {output: (rel err, max abs err)}}."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for d in (80, 288):
            errs[f"d{d}_{str(dtype)[6:]}"] = check_flash(
                rng, f"MLA latent D={d}", 2, MLA_HQ, 1, 300, 300, d, dtype)
    errs["d288_mla_forward"] = check_flash(
        rng, "MLA latent D=288 (B=2 S=2048)", DEC_B, MLA_HQ, 1, DEC_S, DEC_S,
        MLA_D, torch.bfloat16)
    return errs


def check_mla_static_max(rng):
    """(b) The bf16 forward at D=288 in its static-max mode
    (``flash_fwd_wide_kernel``'s STATIC_MAX instance) at mla_forward's B=2,
    S=2048, causal, with "estimate"'s subtrahends and a caller's bound,
    against its plain version on the same subtrahends → {mode: {o, l: (rel
    err, max abs err), gap_running_max}}; raises past the flash gates."""
    return {mode: check_static_max(
        rng, "MLA latent (B=2 S=2048)", DEC_B, MLA_HQ, 1, DEC_S, MLA_D,
        torch.bfloat16, masking.CAUSAL, mode)
        for mode in ("estimate", "caller")}


def check_wide_same_bits(rng):
    """(b) The bf16 forward (both modes), dQ and dK/dV at D=288
    (``flash_fwd_wide_kernel`` and the wide bodies; the dK/dV's group split
    over CTAs and merged in split order) called twice on the same inputs at
    mla_forward's B=2, S=2048: equal bit for bit; raises otherwise.  →
    {"fwd": True, "fwd_row_max": True, "dq": True, "dkv": True,
    "dkv_splits": n}."""
    q, k, v, do, _ = flash_inputs(rng, DEC_B, MLA_HQ, 1, DEC_S, DEC_S, MLA_D,
                                  torch.bfloat16)
    rr = row_ranges_tensor(masking.CAUSAL, DEC_S, DEC_S, None, DEV)
    kw = dict(scale=MLA_D ** -0.5)
    fwd = [flash_fwd(q, k, v, rr, **kw) for _ in range(2)]
    mx = static_row_max(q, k, masking.CAUSAL, rr, "estimate", MLA_D ** -0.5)
    fwd_rm = [flash_fwd(q, k, v, rr, **kw, row_max=mx) for _ in range(2)]
    o, lse = fwd[0]
    args = (q, k, v, do, lse, (do.float() * o).sum(-1), rr)
    dq = [flash_dq(*args, **kw)[0] for _ in range(2)]
    dkv = [flash_dkv(*args, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    same = {"fwd": all(torch.equal(a, b) for a, b in zip(*fwd)),
            "fwd_row_max": all(torch.equal(a, b) for a, b in zip(*fwd_rm)),
            "dq": torch.equal(*dq),
            "dkv": all(torch.equal(a, b) for a, b in zip(*dkv))}
    splits = fbwd.dkv_splits(torch.bfloat16, MLA_D, DEC_B, MLA_HQ, 1, DEC_S,
                             sm_count())
    log(f"MLA D=288 bf16 forward, dQ and dK/dV ({splits} splits), two calls "
        f"bit for bit equal: " + json.dumps(same))
    if not all(same.values()):
        raise AssertionError(f"the D=288 kernels are not deterministic: "
                             f"{same}")
    return {**same, "dkv_splits": splits}


def sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def time_dkv_merge(rng, d=MLA_D):
    """(h) ``merge_dkv_splits`` (flash_dkv_merge_kernel) on the workspace
    of the dK/dV at the MLA train shape (head dim ``d``: 288, or 576 for
    phase 21), held to its plain version bit for bit, beside its byte
    bound and ``torch.sum`` over the splits."""
    splits = fbwd.dkv_splits(torch.bfloat16, d, DEC_B, MLA_HQ, 1, DEC_S,
                             sm_count())
    shape = (DEC_B, 1, DEC_S, d)
    ws = torch.from_numpy(rng.standard_normal(
        (splits, 2) + shape, np.float32)).to(DEV)
    dk, dv = torch.empty(shape, device=DEV), torch.empty(shape, device=DEV)
    fbwd.merge_dkv_splits(ws, dk, dv)
    want_k, want_v = fbwd.merge_dkv_splits_plain(ws)
    torch.cuda.synchronize()
    err = max((dk - want_k).abs().max().item(),
              (dv - want_v).abs().max().item())
    if err != 0.0:
        raise AssertionError(f"flash_dkv_merge_kernel differs from its plain "
                             f"version: {err}")
    kernel = lambda: fbwd.merge_dkv_splits(ws, dk, dv)  # noqa: E731
    t = {"plain_ms": time_ms(lambda: fbwd.merge_dkv_splits_plain(ws), 20),
         "ms": time_ms(kernel, 100),
         "library_ms": time_ms(lambda: torch.sum(ws, 0), 100)}
    t["plain_ms_2"] = time_ms(lambda: fbwd.merge_dkv_splits_plain(ws), 20)
    t["ms_2"] = time_ms(kernel, 100)
    t["device_ms"] = device_ms(kernel, 100)
    t["bound_ms"], t["bound_by"] = bound_of(
        0, ws.numel() * 4 + 2 * dk.numel() * 4)
    t.update(max_abs_err=err, splits=splits,
             shape=f"ws [{splits}, 2, {DEC_B}, 1, {DEC_S}, {d}] fp32")
    log(f"flash_dkv_merge times at the MLA train shape, D={d}: "
        + json.dumps(t))
    return t


def check_int8_p_spans(rng):
    """(c) The quantized forward in the north-star's int8-Q / int8-P mode
    against ``qattn_fwd_plain(kv_tile=block_kv)`` at the north-star shape,
    for NORTH_STAR_BLOCKS' block_kv and for 128.  → {label: errors}."""
    q, kq, vq, _ = north_star_inputs(device_generator(rng))
    args, kw = qattn_arguments(q, kq, vq, quantize_q=True)
    errs = {}
    for block_kv in (NS_BLOCKS.block_kv, 128):
        tile = int8_p_tile(BlockSizes(block_kv=block_kv), NS_S)
        out = qattn_fwd(*args, **kw, kv_tile=tile)
        torch.cuda.synchronize()
        errs[f"block_kv_{block_kv}"] = check_pair(
            f"qattn_fwd int8 Q / int8 P over {tile}-key spans (north-star)",
            out, qattn_fwd_plain(*args, **kw, kv_tile=tile))
    return errs


def wo_pair(a, wq, c=None):
    """(kernel, plain, args, kw) of ``quantized_matmul(a, wq, c=c)``."""
    folded, args, kw = wo_arguments(a, wq, c)
    if folded:
        return wo_folded_gemm, wo_folded_gemm_plain, args, kw
    return wo_gemm, wo_gemm_plain, args, kw


def check_wo(name, a, wq, c=None):
    """The weight-only kernel of ``quantized_matmul(a, wq, c=c)`` against
    its plain version, fp32 out, at WO_TOL, and its bf16 result equal to
    the fp32 one rounded, bit for bit.  → (kernel, (rel err, max abs
    err))."""
    kernel, plain, args, kw = wo_pair(a, wq, c)
    out = kernel(*args, **kw)
    out16 = kernel(*args, **kw, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    e = (rel_err(out, ref), max_abs(out, ref))
    log(f"{kernel.__name__} {name} (M={a.shape[0]} N={wq.shape[0]} "
        f"K={a.shape[1]}, {wo_gemm_body(args[0].dtype)} tile): rel "
        f"{e[0]:.2e} max abs {e[1]:.2e} (tol {WO_TOL}); bf16 out = fp32 out "
        "rounded")
    if not e[0] <= WO_TOL:
        raise AssertionError(f"{name} disagrees with its plain version: {e}")
    if not torch.equal(out16, out.to(torch.bfloat16)):
        raise AssertionError(f"{name}: the bf16 result is not the fp32 one "
                             "rounded")
    return kernel, e


def check_wo_gemm(rng):
    """(d) Both weight-only GEMM kernels against their plain versions at the
    decompression shape in each mode of WO_CASES, with and without ``c=``
    (``check_wo``).  → {label: (rel err, max abs err)}."""
    m, n, k = DEC_B * DEC_S, DEC_H * DEC_DH, DEC_DC
    g = device_generator(rng)
    errs = {}
    for label, cfg, adtype in WO_CASES:
        for with_c in (False, True):
            a = torch.randn((m, k), generator=g, device=DEV).to(adtype)
            wq = quantize(torch.randn((n, k), generator=g, device=DEV)
                          * k ** -0.5, cfg)
            c = (torch.randn((m, n), generator=g, device=DEV) if with_c
                 else None)
            name = f"{label}{' c=' if with_c else ''}"
            kernel, errs[name] = check_wo(name, a, wq, c)
            if (kernel is wo_folded_gemm) != label.startswith("folded"):
                raise AssertionError(f"{name}: dispatched to {kernel}")
    return errs


def run_decompression(rng):
    """(e) The decompression path: ``mla_decompress(latent, W_uk_q, W_uv_q,
    16)`` then ``flash_attention(q, k, v, CAUSAL)`` at B=2, S=2048, against
    ``mla_absorbed_attention`` on the dequantized weights; W_uk/W_uv int8
    ROW (the folded kernel) and int8 BLOCK 128 (the dequant-on-load one),
    the launch counts set to 0 just before and read after; then the path's
    time (with ``--parent``, in turns).  → {config: {rel_l2, launches,
    times}}."""
    b, s, h, dh, dc = DEC_B, DEC_S, DEC_H, DEC_DH, DEC_DC
    g = device_generator(rng)
    latent = torch.randn((b, s, dc), generator=g, device=DEV).to(
        torch.bfloat16)
    q = torch.randn((b, h, s, dh), generator=g, device=DEV).to(torch.bfloat16)
    w_uk = torch.randn((h, dh, dc), generator=g, device=DEV) * dc ** -0.5
    w_uv = torch.randn((h, dc, dh), generator=g, device=DEV) * dc ** -0.5
    out = {}
    for name, cfg in (("int8 ROW", WEIGHT_CFG),
                      ("int8 BLOCK 128", int8_blockwise(128))):
        wk = quantize(w_uk.reshape(h * dh, dc), cfg)
        wv = quantize(w_uv.transpose(1, 2).reshape(h * dh, dc), cfg)
        wo_folded_gemm.launches = wo_gemm.launches = flash_fwd.launches = 0
        k, v = mla_decompress(latent, wk, wv, h)
        o = flash_attention(q, k, v, mask=masking.CAUSAL)
        torch.cuda.synchronize()
        launches = {"wo_folded_gemm": wo_folded_gemm.launches,
                    "wo_gemm": wo_gemm.launches,
                    "flash_fwd": flash_fwd.launches}
        folded = cfg is WEIGHT_CFG
        want = {"wo_folded_gemm": 2 * folded, "wo_gemm": 2 * (not folded),
                "flash_fwd": 1}
        ref = mla_absorbed_attention(
            q, latent, dequantize(wk).reshape(h, dh, dc),
            dequantize(wv).reshape(h, dh, dc).transpose(1, 2),
            mask=masking.CAUSAL)
        err = rel_l2(o, ref.float())
        log(f"decompression {name}: mla_decompress + flash_attention vs "
            f"absorbed, rel L2 {err:.3e} (tol {DECOMPRESS_TOL}); launches "
            + json.dumps(launches))
        if launches != want:
            raise AssertionError(f"decompression {name}: launches "
                                 f"{launches}, expected {want}")
        if not (np.isfinite(err) and err <= DECOMPRESS_TOL
                and o.shape == (b, h, s, dh)):
            raise AssertionError(f"decompression {name} disagrees with the "
                                 f"absorbed path: {err}")
        path = (lambda wk=wk, wv=wv: flash_attention(  # noqa: E731
            q, *mla_decompress(latent, wk, wv, h), mask=masking.CAUSAL))
        times = {"ms": time_ms(path, 10), "ms_2": time_ms(path, 10)}
        parent_turns(f"decompression {name}: mla_decompress + "
                     "flash_attention", times, path, 10)
        log(f"decompression {name} path times (B={b} S={s}): "
            + json.dumps(times))
        out[name] = {"rel_l2": err, "launches": launches, "times": times}
    return out


def run_absorbed_quantized(rng):
    """(e) ``mla_absorbed_attention`` over a per-token int8 latent (ROW
    CENTERED, logical [B, 1, S, d_c], as tests/test_mla.py quantizes it) at
    B=2, S=2048, causal: the quantized forward at MLA's geometry (Hq=16
    over Hkv=1, D=256), its launch count set to 0 just before and read
    after.  The kernel on that call's arguments (rebuilt as
    ``quantized_flash_attention_forward`` builds them) against its plain
    version, the path's output against the plain O carried through W_uv,
    and against the fp32 dense attention on the dequantized latent
    (ABSORBED_INT8_TOL).  → {errors, launches}."""
    b, s, h, dh, dc = DEC_B, DEC_S, DEC_H, DEC_DH, DEC_DC
    g = device_generator(rng)
    latent = torch.randn((b, s, dc), generator=g, device=DEV)
    q = torch.randn((b, h, s, dh), generator=g, device=DEV).to(torch.bfloat16)
    w_uk = torch.randn((h, dh, dc), generator=g, device=DEV) * dc ** -0.5
    w_uv = torch.randn((h, dc, dh), generator=g, device=DEV) * dc ** -0.5
    c = quantize(latent[:, None], QuantConfig(
        granularity=QuantGranularity.ROW, strategy=QuantStrategy.CENTERED))
    qattn_fwd.launches = 0
    o = mla_absorbed_attention(q, c, w_uk, w_uv, mask=masking.CAUSAL)
    torch.cuda.synchronize()
    launches = qattn_fwd.launches
    if launches != 1:
        raise AssertionError(f"absorbed quantized latent: {launches} "
                             "qattn_fwd launches, expected 1")
    q_lat = torch.einsum("bhsd,hdc->bhsc", q.float(), w_uk.float()).to(q.dtype)
    args, kw = qattn_arguments(q_lat, c, c, mask=masking.CAUSAL,
                               scale=dh ** -0.5)
    tile = main_path_tile(kw, s)
    got = qattn_fwd(*args, **kw, kv_tile=tile)
    torch.cuda.synchronize()
    plain = qattn_fwd_plain(*args, **kw, kv_tile=tile or KV_TILE)
    errs = {"kernel": check_pair(
        f"qattn_fwd {kw['mode'].k_scales} K / {kw['mode'].v_scales} V, Hq=16 "
        "over Hkv=1, D=256 (MLA's quantized latent)", got, plain)}
    o_plain = torch.einsum("bhsc,hcd->bhsd", plain[0].to(q.dtype).float(),
                           w_uv.float())
    errs["path"] = (rel_err(o, o_plain), max_abs(o, o_plain))
    ref = plain_mla_attention(q, dequantize(c)[:, 0], w_uk, w_uv,
                              mask=masking.CAUSAL).float()
    errs["vs_fp32_rel_l2"] = rel_l2(o, ref)
    log(f"mla_absorbed_attention over an int8 latent (B={b} S={s}): vs the "
        f"plain O through W_uv rel {errs['path'][0]:.2e} (tol "
        f"{FLASH_TOL[torch.bfloat16]}), vs fp32 dense rel L2 "
        f"{errs['vs_fp32_rel_l2']:.3e} (tol {ABSORBED_INT8_TOL}); "
        f"qattn_fwd launches {launches}")
    if not (errs["path"][0] <= FLASH_TOL[torch.bfloat16]
            and errs["vs_fp32_rel_l2"] <= ABSORBED_INT8_TOL
            and o.shape == (b, h, s, dh)):
        raise AssertionError(f"absorbed quantized latent disagrees: {errs}")
    return {"errors": errs, "launches": launches}


def time_wo_call(label, a, wq, vectors, iters, plain_iters=5):
    """The weight-only kernel ``quantized_matmul(a, wq)`` launches, as it
    launches it (``wo_call``: the bf16 result stored by the kernel; by CUDA
    events, and its kernels' device time under the profiler, which the
    events exceed where the host's launch is the longer) and in fp32,
    beside its bound (A, the payload and its scale vectors read once,
    the bf16 result written once; or 2·M·N·K over the bf16 peak), its plain
    version at bf16 out (timed once, ``plain_iters`` calls) and
    ``torch.matmul`` of A by the pre-dequantized bf16 Wᵀ.  With
    ``--parent``, ``quantized_matmul``'s call in turns (the parent: its fp32
    kernel, then the cast)."""
    m, k = a.shape
    n = wq.shape[0]
    kernel, plain, args, kw = wo_pair(a, wq)
    bf16 = torch.bfloat16
    folded = kernel is wo_folded_gemm
    call = (lambda: wo_call(folded, args, kw, bf16))  # noqa: E731
    wbt = dequantize(wq).to(bf16).t().contiguous()
    t = {"plain_ms": time_ms(lambda: plain(*args, **kw, out_dtype=bf16),
                             plain_iters, warmup=1),
         "ms": time_ms(call, iters)}
    t["ms_2"] = time_ms(call, iters)
    t["ms_fp32_out"] = time_ms(lambda: kernel(*args, **kw), iters)
    t["library_ms"] = time_ms(lambda: a @ wbt, iters)
    t["device_ms"] = device_ms(call, iters)
    t["body"] = wo_gemm_body(args[0].dtype)
    t["tile_rows"], t["k_splits"] = wo_tile(
        m, n, k, torch.cuda.get_device_properties(DEV).multi_processor_count)
    parent_turns(label, t, call, iters)
    t["bound_ms"], t["bound_by"] = bound_of(
        2 * m * n * k, 2 * m * k + wq.nbytes_payload + 4 * vectors + 2 * m * n)
    log(f"{label} times (M={m} N={n} K={k}, bf16 A, {t['body']} tile): "
        + json.dumps(t))
    return t


def time_wo_gemm(rng):
    """Both weight-only kernels at the decompression shape in
    ``mla_decompress``'s modes (bf16 latent; int8 ROW folded, int8 BLOCK
    128 dequant-on-load), by ``time_wo_call``."""
    m, n, k = DEC_B * DEC_S, DEC_H * DEC_DH, DEC_DC
    g = device_generator(rng)
    a = torch.randn((m, k), generator=g, device=DEV).to(torch.bfloat16)
    w = torch.randn((n, k), generator=g, device=DEV) * k ** -0.5
    times = {}
    for name, cfg, vectors in (("wo_folded_gemm", WEIGHT_CFG, n),
                               ("wo_gemm", int8_blockwise(128), 2 * k)):
        times[name] = time_wo_call(f"{name} {cfg.granularity.value} M={m}",
                                   a, quantize(w, cfg), vectors, 20)
    return times


def mla_dense_kv(pool, row, n, pt, vtz=MLA_VTZ):
    """One sequence's first n latent states as K [1, n, D] and V (the rope
    tail of vtz lanes zeroed), bf16."""
    t = torch.arange(n, device=DEV)
    k = pool[:, row.long()[t // pt], t % pt]
    v = k.clone()
    v[..., k.shape[-1] - vtz:] = 0
    return k, v


def sdpa_backend(*args, **kw) -> str:
    """The SDPA backend torch picks for these arguments on the card
    (``torch._fused_sdp_choice``, as ``F.scaled_dot_product_attention``
    asks it)."""
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(*args, **kw)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"not determined ({type(e).__name__}: {e})"


def time_mla_paged(rng, lengths, hq=MLA_HQ, d=MLA_D, vtz=MLA_VTZ,
                   scale=MLA_SCALE, label="MLA D=288", turns=True):
    """Both paged kernels at a latent geometry (MLAConfig()'s by default)
    with a bf16 latent pool: decode at the engine's decode lengths, a
    256-token prefill chunk at offset 512; beside their bounds (one state
    per live token read once; QK over d lanes, PV over d - vtz), plain
    versions and SDPA over the dense K/V (the backend torch took named);
    ``turns``: timed on the parent's kernels too, with ``--parent``."""
    pt, num_pages, max_pages, chunk, offset = 256, 256, 16, 256, 512
    dv = d - vtz
    lengths = np.asarray(lengths, np.int32)
    b = len(lengths)
    pool, _ = mla_pool(rng, False, num_pages, pt, d)
    kw = dict(page_tokens=pt, v_tail_zero=vtz, scale=scale)
    table = page_tables(rng, lengths, pt, num_pages, max_pages)
    q = torch.from_numpy(rng.standard_normal((b, hq, d), np.float32)).to(
        DEV, torch.bfloat16)
    ln = torch.from_numpy(lengths).to(DEV)
    s_max = int(lengths.max())
    k = torch.zeros(b, 1, s_max, d, device=DEV, dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    for i, n in enumerate(lengths):
        k[i, :, :n], v[i, :, :n] = mla_dense_kv(pool, table[i], int(n), pt,
                                                vtz)
    mask = (torch.arange(s_max, device=DEV)[None, :]
            < ln[:, None].long()).view(b, 1, 1, s_max)
    q4 = q.view(b, hq, 1, d)
    dec = {"plain_ms": time_ms(lambda: paged_decode_attention_plain(
        q, pool, table, ln, **kw), 10),
        "ms": time_ms(lambda: paged_decode_attention(q, pool, table, ln,
                                                     **kw), 50),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, enable_gqa=True, scale=scale), 50)}
    dec["ms_2"] = time_ms(lambda: paged_decode_attention(q, pool, table, ln,
                                                         **kw), 50)
    dec["device_ms"] = device_ms(
        lambda: paged_decode_attention(q, pool, table, ln, **kw), 50)
    dec["library_device_ms"] = device_ms(
        lambda: F.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, enable_gqa=True, scale=scale), 50)
    dec["library_backend"] = sdpa_backend(q4, k, v, mask, enable_gqa=True,
                                          scale=scale)
    dec["library_kernels"] = sorted(device_ms_by_label(
        lambda: F.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, enable_gqa=True, scale=scale), 5))
    if turns:
        parent_turns(f"paged_decode {label}", dec,
                     lambda: paged_decode_attention(q, pool, table, ln,
                                                    **kw), 50, device=True)
    live = int(lengths.sum())
    dec["bound_ms"], dec["bound_by"] = bound_of(
        2 * hq * live * (d + dv),
        live * d * 2 + 2 * b * hq * d * 2 + table.numel() * 4 + b * 4)
    log(f"paged_decode {label} bf16 times at lengths {lengths.tolist()}: "
        + json.dumps(dec))
    row = page_tables(rng, [offset + chunk], pt, num_pages, max_pages)[0]
    q = torch.from_numpy(rng.standard_normal((hq, chunk, d), np.float32)).to(
        DEV, torch.bfloat16)
    n = offset + chunk
    k, v = mla_dense_kv(pool, row, n, pt, vtz)
    mask = (torch.arange(n, device=DEV)[None, :]
            <= offset + torch.arange(chunk, device=DEV)[:, None])
    pf = {"plain_ms": time_ms(lambda: paged_prefill_attention_plain(
        q, pool, row, offset, **kw), 10),
        "ms": time_ms(lambda: paged_prefill_attention(q, pool, row, offset,
                                                      **kw), 20),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=mask, enable_gqa=True,
            scale=scale), 20)}
    pf["ms_2"] = time_ms(lambda: paged_prefill_attention(q, pool, row, offset,
                                                         **kw), 20)
    pf["device_ms"] = device_ms(
        lambda: paged_prefill_attention(q, pool, row, offset, **kw), 20)
    pf["library_device_ms"] = device_ms(
        lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=mask, enable_gqa=True,
            scale=scale), 20)
    pf["library_backend"] = sdpa_backend(q[None], k[None], v[None], mask,
                                         enable_gqa=True, scale=scale)
    pf["library_kernels"] = sorted(device_ms_by_label(
        lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=mask, enable_gqa=True,
            scale=scale), 5))
    if turns:
        parent_turns(f"paged_prefill {label} offset {offset}", pf,
                     lambda: paged_prefill_attention(q, pool, row, offset,
                                                     **kw), 20, device=True)
    visible = chunk * offset + chunk * (chunk + 1) // 2
    pf["bound_ms"], pf["bound_by"] = bound_of(
        2 * hq * visible * (d + dv),
        n * d * 2 + 2 * hq * chunk * d * 2 + row.numel() * 4)
    log(f"paged_prefill {label} bf16 times at offset {offset}: "
        + json.dumps(pf))
    return {"decode": dec, "prefill": pf}


def run_mla(seed, dec_lens):
    """Phase 12 (a)-(h), inputs from a fifth generator (seed + 4), the
    model's weights from ``seed`` → (record, phase seconds)."""
    rng = np.random.default_rng(seed + 4)
    out, phase = {}, {}
    t = time.perf_counter()
    with torch.inference_mode():
        out["paged_errors"] = check_mla_paged(rng)
        out["flash_errors"] = check_mla_flash(rng)
        out["flash_static_max_errors"] = check_mla_static_max(rng)
        out["flash_same_bits"] = check_wide_same_bits(rng)
        out["int8_p_errors"] = check_int8_p_spans(rng)
        out["wo_errors"] = check_wo_gemm(rng)
        out["decompression"] = run_decompression(rng)
        out["absorbed_quantized"] = run_absorbed_quantized(rng)
    phase["mla_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    cfg = MLAConfig()  # 8 x 1024, 16 heads, d_c 256 + d_r 32, bf16
    params = init_mla_params(cfg, torch.Generator().manual_seed(seed),
                             device=DEV)
    qparams = quantize_mla_weights(params)
    out["logits_rel_l2"] = {}
    with torch.inference_mode():
        mla = dict(executor=mla_executor(), oracle=MLA_ORACLE)
        out["logits_rel_l2"]["float"] = check_logits(
            cfg, params, np.random.default_rng(seed + 5),
            label="MLA float latent", **mla)
        out["logits_rel_l2"]["w8a8+int8"] = check_logits(
            cfg, qparams, np.random.default_rng(seed + 5),
            params32=dequantized_fp32(qparams), quantized=8,
            tol=QUANT_LOGITS_TOL[8], label="MLA w8a8+int8 latent", **mla)
    phase["mla_logits"] = time.perf_counter() - t
    t = time.perf_counter()
    out["engines"] = {}
    for label, p, pool in (("float", params, False),
                           ("w8a8+int8", qparams, 8)):
        launches, stats, _, rates = run_engine(
            cfg, p, seed, quantized_cache=pool, label=f"MLA engine {label}",
            executor=mla_executor(), layer_gemms=8)
        out["engines"][label] = {"launches": launches, "rates": rates,
                                 "model_calls": stats["prefill_calls"]
                                 + stats["decode_calls"]}
    phase["mla_engines"] = time.perf_counter() - t
    del params, qparams
    t = time.perf_counter()
    with torch.inference_mode():
        out["paged_times"] = time_mla_paged(rng, dec_lens)
        out["wo_times"] = time_wo_gemm(rng)
    out["flash_times"] = time_flash(rng, DEC_B, MLA_HQ, 1, DEC_S, MLA_D)
    with torch.inference_mode():
        out["merge_times"] = time_dkv_merge(rng)
    phase["mla_times"] = time.perf_counter() - t
    return out, phase

# --------------------------------------------------------------------------
# Phase 13: the GEMM engine
# --------------------------------------------------------------------------

# The flagship's projections over 2 × 2048 tokens: M rows, (N, K) of
# q/o, k/v, gate/up and down.
GEMM_M = 4096
ENGINE_SHAPES = ((1024, 1024), (256, 1024), (4096, 1024), (1024, 4096))
# The quantized-A and small-block kernels vs their plain versions on the
# same arguments, fp32 results: the same exact products (int × bf16,
# bf16 × bf16, fp32 × fp32) summed in another order.  Max abs over the
# plain's max abs.  comp_gemm is held bit for bit.
GEMM_KERNEL_TOL = TOLERANCES["fp32"]
# matmul vs dequantized_gemm_reference (or the exact fp32 product of the
# dequantized operands), relative L2: an fp32 compute dtype, and a bf16
# one (an operand or the result rounded to bf16).
MATMUL_TOL = {"fp32": 1e-5, "bf16": 1e-2}
GEMM_KERNELS = (qa_folded_gemm, qa_gemm, comp_gemm, comp_small_gemm,
                wo_folded_gemm, wo_gemm, dyn_gemm)
F16 = torch.float16


def blk(bs, strategy="centered"):
    return qcfg(gran="block", strategy=strategy, block_size=bs)


# (label, A config, B config or B dtype): the kernels' modes in (a).
GEMM_KERNEL_MODES = (
    ("qa folded int8 ROW", qcfg(), torch.bfloat16),
    ("qa folded int4 ROW", qcfg(bits=4), torch.bfloat16),
    ("qa folded int8 TENSOR", qcfg(gran="tensor"), torch.bfloat16),
    ("qa int8 ROW ASYMMETRIC", qcfg(strategy="asymmetric"), torch.bfloat16),
    ("qa int8 BLOCK 128", blk(128), torch.bfloat16),
    ("qa int8 ROW fp32 B", qcfg(), torch.float32),
    ("comp BLOCK 128 ASYMMETRIC", blk(128, "asymmetric"),
     blk(128, "asymmetric")),
    ("comp BLOCK 512 ASYMMETRIC", blk(512, "asymmetric"),
     blk(512, "asymmetric")),
    ("comp-small BLOCK 16", blk(16), blk(16)),  # m16n8k16 products
    ("comp-small BLOCK 32", blk(32), blk(32)),
    ("comp-small BLOCK 64", blk(64), blk(64)),
    ("comp-small BLOCK 8", blk(8), blk(8)),  # the scalar tile
)


def gemm_kernel_pair(a, b, c=None):
    """(kernel, plain, args, kw) of the GEMM kernel ``matmul(a, b, c=c)``
    launches for a quantized A (C only for a quantized B: the qa path
    adds it outside its kernel)."""
    if isinstance(b, QuantizedTensor):
        small, args, kw = comp_arguments(a, b, c)
        return ((comp_small_gemm, comp_small_gemm_plain) if small
                else (comp_gemm, comp_gemm_plain)) + (args, kw)
    folded, args, kw = qa_arguments(a, b)
    return ((qa_folded_gemm, qa_folded_gemm_plain) if folded
            else (qa_gemm, qa_gemm_plain)) + (args, kw)


def gemm_mode_operands(g, m, n, k, a_spec, b_spec, with_c=False):
    """A [M, K] quantized with ``a_spec`` (shifted, so asymmetric zero
    points are nonzero) or of that dtype; B [K, N] of dtype ``b_spec`` or
    Bᵀ [N, K] quantized with it; C fp32 [M, N] or None."""
    a = torch.randn((m, k), generator=g, device=DEV)
    a = (quantize(a + 0.25, a_spec) if isinstance(a_spec, QuantConfig)
         else a.to(a_spec))
    if isinstance(b_spec, QuantConfig):
        b = quantize(torch.randn((n, k), generator=g, device=DEV) - 0.2,
                     b_spec)
    else:
        b = (torch.randn((k, n), generator=g, device=DEV)
             * k ** -0.5).to(b_spec)
    c = torch.randn((m, n), generator=g, device=DEV) if with_c else None
    return a, b, c


def check_gemm_kernels(rng):
    """(a) The four kernels against their plain versions in each mode of
    GEMM_KERNEL_MODES at the flagship's projection shapes (M = 4096) and
    gemm_bench's (M = 128 and 4096, N = K = 8192); the compensated modes
    with and without ``c=``.  → {label: (rel err, max abs err)}, worst
    over the shapes."""
    g = device_generator(rng)
    shapes = [(GEMM_M, n, k) for n, k in ENGINE_SHAPES] + list(GEMM_SHAPES)
    errs = {}
    for label, a_cfg, b_spec in GEMM_KERNEL_MODES:
        cs = (False, True) if isinstance(b_spec, QuantConfig) else (False,)
        for with_c in cs:
            name = f"{label}{' c=' if with_c else ''}"
            worst = (0.0, 0.0)
            for m, n, k in shapes:
                a, b, c = gemm_mode_operands(g, m, n, k, a_cfg, b_spec,
                                             with_c)
                kernel, plain, args, kw = gemm_kernel_pair(a, b, c)
                out = kernel(*args, **kw)
                torch.cuda.synchronize()
                ref = plain(*args, **kw)
                e = (rel_err(out, ref), max_abs(out, ref))
                worst = max(worst[0], e[0]), max(worst[1], e[1])
                exact = kernel is comp_gemm
                if not (torch.equal(out, ref) if exact
                        else e[0] <= GEMM_KERNEL_TOL):
                    raise AssertionError(
                        f"{kernel.__name__} {name} M={m} N={n} K={k} "
                        f"disagrees with its plain version: {e}")
                del a, b, c, args, out, ref
            errs[name] = worst
            log(f"{kernel.__name__} {name}: {len(shapes)} shapes, worst rel "
                f"{worst[0]:.2e} max abs {worst[1]:.2e} (tol "
                f"{'bit for bit' if exact else GEMM_KERNEL_TOL})")
    return errs


# (label, A spec, B spec, the kernel matmul launches or None, compute
# dtype, with c, options): every operand kind and dispatch arm in (b).
MATMUL_CASES = (
    ("float x float fp32", torch.float32, torch.float32, None, "fp32",
     False, {}),
    ("float x float bf16", torch.bfloat16, torch.bfloat16, None, "bf16",
     False, {}),
    ("float x float fp32 transpose_a + c", torch.float32, torch.float32,
     None, "fp32", True, dict(transpose_a=True)),
    ("float x QT folded int8 ROW", torch.bfloat16, qcfg(), wo_folded_gemm,
     "bf16", False, {}),
    ("float x QT int8 BLOCK 128 + c", torch.bfloat16, blk(128), wo_gemm,
     "bf16", True, {}),
    ("float x QT fp32 A, int8 ROW ASYMMETRIC", torch.float32,
     qcfg(strategy="asymmetric"), wo_gemm, "fp32", False, {}),
    ("QT x float folded int8 ROW", qcfg(), torch.bfloat16, qa_folded_gemm,
     "bf16", False, {}),
    ("QT x float folded int4 ROW + c", qcfg(bits=4), torch.bfloat16,
     qa_folded_gemm, "bf16", True, {}),
    ("QT x float folded int8 TENSOR, fp16 B", qcfg(gran="tensor"), F16,
     qa_folded_gemm, "bf16", False, {}),
    ("QT x float int8 ROW ASYMMETRIC", qcfg(strategy="asymmetric"),
     torch.bfloat16, qa_gemm, "bf16", False, {}),
    ("QT x float int8 BLOCK 128", blk(128), torch.bfloat16, qa_gemm, "bf16",
     False, {}),
    ("QT x float int8 ROW, fp32 B + c", qcfg(), torch.float32, qa_gemm,
     "fp32", True, {}),
    ("QT x QT BLOCK 128 ASYMMETRIC", blk(128, "asymmetric"),
     blk(128, "asymmetric"), comp_gemm, "fp32", False, {}),
    ("QT x QT BLOCK 512 + c", blk(512), blk(512), comp_gemm, "fp32", True,
     {}),
    ("QT x QT BLOCK 32", blk(32), blk(32), comp_small_gemm, "fp32", False,
     {}),
    ("QT x QT BLOCK 64 ASYMMETRIC + c", blk(64, "asymmetric"),
     blk(64, "asymmetric"), comp_small_gemm, "fp32", True, {}),
    ("QT x QT degraded: int4 A", qcfg(bits=4, gran="block",
                                      strategy="centered", block_size=128),
     blk(128), wo_gemm, "bf16", False, {}),
    ("QT x QT degraded: blocks 128 / 64", blk(128), blk(64), wo_gemm,
     "bf16", False, {}),
    ("QT x QT degraded: ROW B", blk(128), qcfg(), wo_folded_gemm, "bf16",
     False, {}),
    ("QT x QT degraded: no fast int8 path + c", blk(128), blk(128), wo_gemm,
     "bf16", True, dict(no_int8=True)),
)


def matmul_reference(a, b, c):
    """The exact fp32 product of the dequantized operands (+ C):
    ``dequantized_gemm_reference`` for two quantized ones."""
    if isinstance(a, QuantizedTensor) and isinstance(b, QuantizedTensor):
        ref = dequantized_gemm_reference(a, b)
    else:
        af = dequantize(a) if isinstance(a, QuantizedTensor) else a.float()
        bf = (dequantize(b).t() if isinstance(b, QuantizedTensor)
              else b.float())
        ref = af @ bf
    return ref if c is None else ref + c


def run_matmul_paths(rng):
    """(b) ``matmul`` at M=4096, N=K=1024 over MATMUL_CASES, each call
    with every GEMM kernel's count set to 0 just before and read just
    after: exactly one launch of the expected kernel (none for float ×
    float), none of the others.  → {label: {rel_l2, launches}}."""
    g = device_generator(rng)
    m, n, k = GEMM_M, 1024, 1024
    probe = capabilities.probe_capabilities
    out = {}
    for label, a_spec, b_spec, want, compute, with_c, opts in MATMUL_CASES:
        a, b, c = gemm_mode_operands(g, m, n, k, a_spec, b_spec, with_c)
        a_in, desc = a, None
        if opts.get("transpose_a"):
            a_in = a.t().contiguous()
            desc = GEMMDescriptor(m=m, n=n, k=k, transpose_a=True)
        if opts.get("no_int8"):
            capabilities.probe_capabilities = (
                lambda device=None: dataclasses.replace(
                    probe(device), has_int8_mxu=False))
        for fn in GEMM_KERNELS:
            fn.launches = 0
        try:
            res = matmul(a_in, b, descriptor=desc, c=c)
            torch.cuda.synchronize()
        finally:
            capabilities.probe_capabilities = probe
        launches = {fn.__name__: fn.launches for fn in GEMM_KERNELS}
        expected = {fn.__name__: int(fn is want) for fn in GEMM_KERNELS}
        err = rel_l2(res, matmul_reference(a, b, c))
        log(f"matmul {label}: rel L2 {err:.3e} (tol {MATMUL_TOL[compute]}), "
            f"launches {[k_ for k_, v in launches.items() if v]}")
        if launches != expected:
            raise AssertionError(f"matmul {label}: launches {launches}, "
                                 f"expected {expected}")
        if not (np.isfinite(err) and err <= MATMUL_TOL[compute]
                and res.shape == (m, n)):
            raise AssertionError(f"matmul {label} disagrees with the "
                                 f"dequantized reference: {err}")
        out[label] = {"rel_l2": err, "launches": launches}
    return out


# gemm_bench-shape arm of utils/profiling.py each kernel is timed on (its
# label: the kernel's name, and the payload's for the weight-only ones),
# the library call it is set beside, and what bounds its operations.
GEMM_TIMED = (
    ("qa_folded_gemm", "qa_folded_int8_row", BF16_FLOPS),
    ("qa_gemm", "qa_int8_row_asymmetric", BF16_FLOPS),
    ("comp_gemm", "compensated_int8", INT8_OPS),
    ("comp_small_gemm", "compensated_small_int8_b64", INT8_OPS),
    ("wo_gemm int8", "weight_only_int8", BF16_FLOPS),
    ("wo_gemm int4", "weight_only_int4", BF16_FLOPS),
    ("wo_folded_gemm", "weight_only_folded_int8_row", BF16_FLOPS),
)
WO_LIBRARY = "torch.matmul of the bf16 A by the pre-dequantized bf16 Wᵀ"
GEMM_LIBRARY = {
    "qa_folded_gemm": "torch.matmul of the dequantized bf16 A by the bf16 B",
    "qa_gemm": "torch.matmul of the dequantized bf16 A by the bf16 B",
    "comp_gemm": "torch._int_mm over the int8 payloads (the raw int32 "
                 "product only)",
    "comp_small_gemm": "fp32 torch.matmul of the dequantized operands, TF32 "
                       "off",
    "wo_gemm": WO_LIBRARY,
    "wo_folded_gemm": WO_LIBRARY,
}


def scalar_comp_small_call(args, kw):
    """``comp_small_gemm``'s scalar route as a parent without the
    small-block tensor-core tile (no ``mfa_comp_small_body``), whose wrapper
    took the per-element [K] vectors from ``comp_arguments``, ran it: the
    vectors
    expanded here, outside the timed call, and the call launching the
    library's ``mfa_comp_small_gemm`` on them."""
    qa, qb, sa, za, sb, zb = args[:6]
    bs, c = kw["bs"], kw["c"]
    (s_a, zs_a), (s_b, zs_b) = (qgemm._block_vectors(sa, za, bs),
                                qgemm._block_vectors(sb, zb, bs))
    (m, k), n = qa.shape, qb.shape[0]

    def call():
        out = torch.empty((m, n), dtype=torch.float32, device=qa.device)
        rc = _build.kernel_function(
            "mfa_comp_small_gemm", qgemm._COMP_SMALL_ARGS)(
            qa.data_ptr(), qb.data_ptr(), s_a.data_ptr(), zs_a.data_ptr(),
            s_b.data_ptr(), zs_b.data_ptr(),
            None if c is None else c.data_ptr(), out.data_ptr(), m, n, k,
            torch.cuda.current_stream(qa.device).cuda_stream)
        _build.check_launch(rc, "comp_small_gemm")
        return out
    return call


def time_gemm_kernels(rng):
    """(c) The seven kernels' arms at gemm_bench's shapes on
    utils/profiling.py's arms, beside their bounds (the operands read once,
    the fp32 result written once, bf16 for the weight-only ones; for the
    compensated kernels the per-block scales and zero points too, not the
    block sums their wrapper derives from the operands; or
    2·M·N·K over the bf16 peak for the quantized-A and weight-only kernels,
    over the int8 peak for both compensated kernels: their operands are
    int8 payloads with per-block scales, whose block products the int8
    tensor cores take), the kernels' device time, plain versions and
    library calls (GEMM_LIBRARY).  The kernels are timed on arguments made
    before the timed calls; the compensated kernels' whole
    ``compensated_matmul`` call (``call_ms``: the arguments, the block sums
    among them, and the kernel) too.  The parent's small-block turns run
    its scalar kernel on per-element vectors expanded before the timed
    calls, as its wrapper took them.
    The weight-only kernels are first held to their plain versions there
    (``check_wo``) and timed by ``time_wo_call``.
    → {label: {"m{M}": times}}."""
    g = device_generator(rng)
    times = {}
    for name, arm, peak in GEMM_TIMED:
        times[name] = {}
        for m, n, k in GEMM_SHAPES:
            _, (a, b) = gemm_arm(arm, m, n, k, g)
            iters = 10 if m <= 128 else 3
            if name.startswith("wo"):
                _, err = check_wo(f"M={m} N={n} K={k}", a, b)
                folded = name == "wo_folded_gemm"
                t = time_wo_call(f"{name} M={m} N={n} K={k}", a, b,
                                 n if folded else 2 * k, iters,
                                 plain_iters=1 if m > 128 else 2)
                t["rel_err"], t["max_abs_err"] = err
                times[name][f"m{m}"] = t
                del a, b
                continue
            kernel, plain, args, kw = gemm_kernel_pair(a, b)
            if kernel in (qa_gemm, qa_folded_gemm):
                log(f"{name} at M={m} runs the "
                    f"{qa_gemm_body(args[1].dtype)} tile")
            if name.startswith("qa"):
                ad = dequantize(a).to(torch.bfloat16)
                library = (lambda ad=ad, b=b: ad @ b)
                vec = 2 * m * 4
            else:
                if name == "comp_gemm":
                    library = (lambda a=a, b=b: torch._int_mm(
                        a.data, b.data.t()))
                else:
                    ad, bd = dequantize(a), dequantize(b).t()
                    library = (lambda ad=ad, bd=bd: ad @ bd)
                # per block: two scales, two zero points
                vec = 16 * (k // b.config.block_size)
                t_call = time_ms(lambda a=a, b=b: compensated_matmul(a, b),
                                 iters, warmup=1)
            t = {"plain_ms": time_ms(lambda: plain(*args, **kw), 2,
                                     warmup=1),
                 "ms": time_ms(lambda: kernel(*args, **kw), iters,
                               warmup=1)}
            t["ms_2"] = time_ms(lambda: kernel(*args, **kw), iters, warmup=0)
            t["device_ms"] = device_ms(lambda: kernel(*args, **kw), iters)
            t["library_ms"] = time_ms(library, iters, warmup=1)
            if name.startswith("comp"):
                t["call_ms"] = t_call
            scalar_parent = (name == "comp_small_gemm" and PARENT["lib"]
                             is not None and not hasattr(
                                 PARENT["lib"], "mfa_comp_small_body"))
            parent_turns(f"{name} M={m} N={n} K={k}", t,
                         lambda: kernel(*args, **kw), iters,
                         device=name == "comp_small_gemm",
                         parent_kernel=scalar_comp_small_call(args, kw)
                         if scalar_parent else None)
            a_bytes = a.nbytes_payload
            b_bytes = (b.nbytes_payload if isinstance(b, QuantizedTensor)
                       else b.numel() * b.element_size())
            bound = {"bytes": (a_bytes + b_bytes + vec + 4 * m * n)
                     / HBM_BYTES_PER_S * 1e3,
                     "operations": 2 * m * n * k / peak * 1e3}
            t["bound_by"] = max(bound, key=bound.get)
            t["bound_ms"] = bound[t["bound_by"]]
            log(f"{name} times at M={m} N={n} K={k} ({arm}): "
                + json.dumps(t))
            times[name][f"m{m}"] = t
            del a, b, args, kw
    return times


def run_gemm_engine(seed):
    """Phase 13 (a)-(c), inputs from a sixth generator (seed + 5) →
    (record, phase seconds)."""
    rng = np.random.default_rng(seed + 5)
    out, phase = {}, {}
    with torch.inference_mode():
        t = time.perf_counter()
        out["kernel_errors"] = check_gemm_kernels(rng)
        phase["gemm_kernels"] = time.perf_counter() - t
        t = time.perf_counter()
        out["matmul"] = run_matmul_paths(rng)
        phase["gemm_matmul"] = time.perf_counter() - t
        t = time.perf_counter()
        out["times"] = time_gemm_kernels(rng)
        phase["gemm_times"] = time.perf_counter() - t
    return out, phase


# --------------------------------------------------------------------------
# Phase 14: the dispatch layer
# --------------------------------------------------------------------------

# The path's attention shape, the train step's: B, Hq, Hkv, S, D (causal,
# bf16).
MHA_SHAPE = (TRAIN_BATCH, 16, 4, TRAIN_SEQ, 64)
# (a)'s small shapes (B=2, S=300, D=64): (label, Hq, Hkv, interleaved,
# mask).
MHA_SMALL = (
    ("gqa-grouped causal", 8, 2, False, masking.CAUSAL),
    ("gqa-interleaved causal", 8, 2, True, masking.CAUSAL),
    ("mqa causal", 8, 1, False, masking.CAUSAL),
    ("gqa window", 8, 2, False, masking.sliding_window(96)),
)
# (b)'s widths past the path's at B=2, Hq=8, Hkv=2, S=300: bf16 at D =
# 128, 256 and 288 (flash_fwd_wide_kernel), fp32 at D = 64.
STATIC_SMALL = ((torch.bfloat16, 128), (torch.bfloat16, 256),
                (torch.bfloat16, 288), (torch.float32, 64))
# (c): the dynamic GEMM at the flagship projections' distinct (N, K) for
# M = 8 (decode), 256 (a prefill chunk) and the fully quantized forward's
# rows; the weight-only GEMM at gemm_bench's M = 128.
CALIB_DYN_MS = (8, 256, QFWD_M)
CALIB_DYN_NK = ((1024, 1024), (256, 1024), (4096, 1024), (1024, 4096))
CALIB_WO = GEMM_SHAPES[0]
FLASH_KERNELS = (flash_fwd, flash_dq, flash_dkv)


def flash_counts() -> dict:
    return {fn.__name__: fn.launches for fn in FLASH_KERNELS}


def zero_flash_counts():
    for fn in FLASH_KERNELS + (fbwd.merge_dkv_splits,):
        fn.launches = 0


def check_multi_head(rng, label, b, hq, hkv, s, d, mask, interleaved=False):
    """(a) ``MultiHeadAttention.forward``, ``__call__`` with
    ``torch.autograd.grad``, and ``backward`` → their launches; raises
    unless each launches exactly its flash kernels, equals the direct call
    bit for bit, and the forward's O is within the flash gate of its plain
    version."""
    q, k, v, do, _ = flash_inputs(rng, b, hq, hkv, s, s, d, torch.bfloat16)
    mha = MultiHeadAttention(AttentionDescriptor(
        head_dim=d, num_q_heads=hq, num_kv_heads=hkv, mask=mask,
        interleaved_kv=interleaved))
    kw = dict(mask=mask, interleaved_kv=interleaved)
    launches, same = {}, {}
    zero_flash_counts()
    o, lse = mha.forward(q, k, v)
    torch.cuda.synchronize()
    launches["forward"] = flash_counts()
    o2, l2 = flash_attention_forward(q, k, v, **kw)
    same["forward"] = torch.equal(o, o2) and torch.equal(lse, l2)
    rr = row_ranges_tensor(mask, s, s, None, DEV)
    err = rel_err(o, flash_attention_forward_plain(
        q, k, v, rr, scale=d ** -0.5, interleaved_kv=interleaved)[0])

    def grads(fn):
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        return torch.autograd.grad(fn(*leaves), leaves, do)

    zero_flash_counts()
    got = grads(mha)
    torch.cuda.synchronize()
    launches["call_grad"] = flash_counts()
    want = grads(lambda *t: flash_attention(*t, **kw))
    same["call_grad"] = all(torch.equal(a, w) for a, w in zip(got, want))
    zero_flash_counts()
    got = mha.backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    launches["backward"] = flash_counts()
    want = fbwd.flash_attention_backward(q, k, v, o, lse, do, **kw)[:3]
    same["backward"] = all(torch.equal(a, w) for a, w in zip(got, want))
    expect = {"forward": (1, 0, 0), "call_grad": (1, 1, 1),
              "backward": (0, 1, 1)}
    log(f"MultiHeadAttention {label} (B={b} Hq={hq} Hkv={hkv} S={s} D={d}):"
        f" launches {json.dumps(launches)}, equal to the direct calls "
        f"{json.dumps(same)}, O vs plain {err:.2e}")
    if any(tuple(launches[c].values()) != e for c, e in expect.items()):
        raise AssertionError(f"MultiHeadAttention {label} launched "
                             f"{launches}, not {expect}")
    if not all(same.values()):
        raise AssertionError(f"MultiHeadAttention {label} differs from the "
                             f"direct calls: {same}")
    if not err <= FLASH_TOL[torch.bfloat16]:
        raise AssertionError(f"MultiHeadAttention {label}: O {err}")
    return launches


def static_row_max(q, k, mask, rr, mode, scale, interleaved=False):
    """The base-2 subtrahends ``flash_attention_forward`` hands the kernel:
    "estimate"'s, or a caller's bound, the true row max + 5 (natural
    units), times log2(e)."""
    hq, hkv = q.shape[1], k.shape[1]
    heads = [(h % hkv) if interleaved else h // (hq // hkv)
             for h in range(hq)]
    if mode == "estimate":
        sparse = mask.kind == masking.MaskKind.SPARSE_RANGES
        return estimate_row_max_scaled(
            (q.float() * (scale * LOG2E)).to(q.dtype), k, mask,
            row_ranges=rr if sparse else None,
            kv_head_of=lambda h: heads[h], seq_q=q.shape[2],
            seq_kv=k.shape[2]).contiguous()
    kx = k.float()[:, heads]
    s = scale * (q.float() @ kx.transpose(-1, -2))
    return ((s.amax(-1) + 5.0) * LOG2E).contiguous()


def check_static_max(rng, label, b, hq, hkv, s, d, dtype, mask, mode,
                     ranges=None):
    """(b) the static-max kernel against its plain version on the same
    subtrahends → {o, l: (rel err, max abs err), gap: O's rel gap to the
    running-max kernel}; raises past the flash gates."""
    q, k, v, _, _ = flash_inputs(rng, b, hq, hkv, s, s, d, dtype)
    rr = row_ranges_tensor(mask, s, s, ranges, DEV)
    scale = d ** -0.5
    mx = static_row_max(q, k, mask, rr, mode, scale)
    o, lse = flash_fwd(q, k, v, rr, scale=scale, row_max=mx)
    o_run, _ = flash_fwd(q, k, v, rr, scale=scale)
    torch.cuda.synchronize()
    o_ref, l_ref = flash_attention_forward_plain(q, k, v, rr, scale=scale,
                                                 row_max=mx)
    errs = {"o": (rel_err(o, o_ref), max_abs(o, o_ref)),
            "l": (rel_err(lse, l_ref), max_abs(lse, l_ref)),
            "gap_running_max": rel_err(o, o_run)}
    log(f"static-max {label} {str(dtype)[6:]} D={d} {mode}: o "
        f"{errs['o'][0]:.2e} l {errs['l'][0]:.2e}; O's gap to the "
        f"running-max kernel {errs['gap_running_max']:.2e}")
    if not (errs["o"][0] <= FLASH_TOL[dtype]
            and errs["l"][0] <= LSE_TOL[dtype]):
        raise AssertionError(f"static-max {label} {dtype} D={d} {mode} "
                             f"disagrees: {errs}")
    return errs


def check_static_max_all(rng):
    """(b) at the path's shape (bf16, causal), the public entry point's
    launch there, then the widths of STATIC_SMALL over FULL, CAUSAL, a
    window and sparse ranges, each with "estimate" and a caller's bound →
    (errors by case, launches of the entry point)."""
    b, hq, hkv, s, d = MHA_SHAPE
    errs = {}
    for mode in ("estimate", "caller"):
        errs[f"path {mode}"] = check_static_max(
            rng, "path", b, hq, hkv, s, d, torch.bfloat16, masking.CAUSAL,
            mode)
    q, k, v, _, _ = flash_inputs(rng, b, hq, hkv, s, s, d, torch.bfloat16)
    rr = row_ranges_tensor(masking.CAUSAL, s, s, None, DEV)
    mx = static_row_max(q, k, masking.CAUSAL, rr, "estimate", d ** -0.5)
    zero_flash_counts()
    o, lse = flash_attention_forward(q, k, v, mask=masking.CAUSAL,
                                     row_max="estimate")
    torch.cuda.synchronize()
    launches = flash_counts()
    o2, l2 = flash_fwd(q, k, v, rr, scale=d ** -0.5, row_max=mx)
    log(f"flash_attention_forward(row_max='estimate') at the path's shape: "
        f"launches {json.dumps(launches)}")
    if launches != {"flash_fwd": 1, "flash_dq": 0, "flash_dkv": 0}:
        raise AssertionError(f"the static-max entry point launched "
                             f"{launches}")
    if not (torch.equal(o, o2) and torch.equal(lse, l2)):
        raise AssertionError("the static-max entry point differs from the "
                             "kernel on its subtrahends")
    seg = masking.build_segment_ranges(np.repeat(np.arange(6), 50))
    seg[77] = (10, 10)  # an empty row
    masks = (("full", masking.FULL, None), ("causal", masking.CAUSAL, None),
             ("window", masking.sliding_window(96), None),
             ("segments", masking.MaskSpec(masking.MaskKind.SPARSE_RANGES),
              seg))
    for dtype, d in STATIC_SMALL:
        for name, mask, ranges in masks:
            for mode in ("estimate", "caller"):
                errs[f"{str(dtype)[6:]} d{d} {name} {mode}"] = \
                    check_static_max(rng, name, 2, 8, 2, 300, d, dtype,
                                     mask, mode, ranges)
    return errs, launches["flash_fwd"]


def calibrate_gemms(rng):
    """(c) ``AttentionTuner.calibrate_gemm`` into the run's store: the
    chosen plan against the cold start with both device times, read back
    by ``recommend_gemm``, and the GEMM launched under it held to its
    plain version (the dynamic one bit for bit) → {GEMM: record}."""
    tuner = AttentionTuner.shared()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = device_generator(rng)
    out = {}
    cases = [("dynamic", m, n, k) for m in CALIB_DYN_MS
             for n, k in CALIB_DYN_NK]
    cases.append(("weight_only", *CALIB_WO))
    for mode, m, n, k in cases:
        cold = tuner.recommend_gemm(m, n, k, mode=mode)
        t0 = time.perf_counter()
        plan = tuner.calibrate_gemm(m, n, k, mode=mode)
        seconds = time.perf_counter() - t0
        if tuner.recommend_gemm(m, n, k, mode=mode) != plan:
            raise AssertionError(f"{mode} {m}x{n}x{k}: recommend_gemm does "
                                 f"not give {plan} back")
        a = torch.randn((m, k), generator=g, device=DEV).to(torch.bfloat16)
        w = quantize(torch.randn((n, k), generator=g, device=DEV),
                     QuantConfig(bits=8, granularity=QuantGranularity.ROW))
        tile, cold_tile = (tile_of(p, k, mode) for p in (plan, cold))
        if mode == "dynamic":
            planner, wrapper = dyn_tile, dyn_gemm
            qa, sa, rs = quantize_rows(a)
            sb, zb = weight_scales(w)
            args, kw = (qa, w.data, sa, rs, sb, zb), dict(bits=8)
            plain = dyn_gemm_plain
        else:
            planner, wrapper = wo_tile, wo_folded_gemm
            folded, args, kw = wo_arguments(a, w)
            if not folded:
                raise AssertionError("a ROW SYMMETRIC weight is not folded")
            plain = wo_folded_gemm_plain
        if planner(m, n, k, sms, 8) != tile:
            raise AssertionError(f"{mode} {m}x{n}x{k}: the planner does not "
                                 f"take the stored plan {plan}")
        wrapper.launches = 0
        got = wrapper(*args, **kw)  # under the stored plan
        torch.cuda.synchronize()
        ref = plain(*args, **kw)
        err = rel_err(got, ref)
        ok = (torch.equal(got, ref) if mode == "dynamic"
              else err <= WO_TOL) and wrapper.launches == 1
        rec = {"cold_plan": list(cold), "plan": list(plan),
               "cold_tile": list(cold_tile), "tile": list(tile),
               "calibrate_s": seconds,
               "cold_device_ms": device_ms(
                   lambda: wrapper(*args, **kw, tile=cold_tile), 20),
               "plan_device_ms": device_ms(
                   lambda: wrapper(*args, **kw, tile=tile), 20),
               "vs_plain": ("bit for bit" if mode == "dynamic" and ok
                            else err)}
        log(f"calibrate_gemm {mode} M={m} N={n} K={k}: " + json.dumps(rec))
        if not ok:
            raise AssertionError(f"{mode} {m}x{n}x{k} under the stored plan "
                                 f"{plan} disagrees with its plain version "
                                 f"({err}) or launched {wrapper.launches}")
        out[f"{mode} m{m} n{n} k{k}"] = rec
    return out


def run_benchmark():
    """(d) ``QuantizedAttention().benchmark()`` at its defaults; raises
    unless every rate is positive and each error within its quantized
    gate."""
    res = QuantizedAttention().benchmark()
    log("QuantizedAttention().benchmark(): " + json.dumps(res))
    if not (all(np.isfinite(v) and v > 0 for v in res.values())
            and res["int8_rel_err"] <= TOLERANCES["int8_rel"]
            and res["int4_rel_err"] <= TOLERANCES["int4_rel"]):
        raise AssertionError(f"the facade's benchmark: {res}")
    return res


def time_static_max(rng):
    """(e) the static-max kernel, the running-max kernel and SDPA at the
    path's shape: events and device time, beside the static-max plain
    version and the bound (the running-max kernel in ``--parent`` turns)."""
    b, hq, hkv, s, d = MHA_SHAPE
    q, k, v, _, _ = flash_inputs(rng, b, hq, hkv, s, s, d, torch.bfloat16)
    rr = row_ranges_tensor(masking.CAUSAL, s, s, None, DEV)
    kw = dict(scale=d ** -0.5)
    mx = static_row_max(q, k, masking.CAUSAL, rr, "estimate", d ** -0.5)
    static = lambda: flash_fwd(q, k, v, rr, **kw, row_max=mx)  # noqa: E731
    running = lambda: flash_fwd(q, k, v, rr, **kw)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    estimate = lambda: static_row_max(  # noqa: E731
        q, k, masking.CAUSAL, rr, "estimate", d ** -0.5)
    t = {"plain_ms": time_ms(lambda: flash_attention_forward_plain(
        q, k, v, rr, **kw, row_max=mx), 3, warmup=1)}
    for turn in ("", "_2"):
        t[f"ms{turn}"] = time_ms(static, 20)
        t[f"device_ms{turn}"] = device_ms(static, 20)
        t[f"running_max_ms{turn}"] = time_ms(running, 20)
        t[f"running_max_device_ms{turn}"] = device_ms(running, 20)
        t[f"library_ms{turn}"] = time_ms(library, 20)
        t[f"library_device_ms{turn}"] = device_ms(library, 20)
    t["estimate_ms"] = time_ms(estimate, 10)
    t["estimate_device_ms"] = device_ms(estimate, 10)
    pairs = b * hq * s * (s + 1) // 2
    t["bound_ms"], t["bound_by"] = bound_of(
        4 * d * pairs, 2 * (b * hq * s * d + 2 * b * hkv * s * d) + 8 * s
        + 4 * (b * hq * s * d + 2 * b * hq * s))
    t["body"] = fwd_body(q.dtype, d)
    parent_turns(f"flash_fwd running max B={b} S={s} D={d} (phase 14)", t,
                 running, 20, device=True)
    log(f"static-max times at B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal "
        "bf16: " + json.dumps(t))
    return t


def run_dispatch_layer(seed):
    """Phase 14 (a)-(e), inputs from an eighth generator (seed + 7) →
    (record, phase seconds)."""
    rng = np.random.default_rng(seed + 7)
    out, phase = {}, {}
    t = time.perf_counter()
    b, hq, hkv, s, d = MHA_SHAPE
    out["multi_head"] = {"path": check_multi_head(
        rng, "path causal", b, hq, hkv, s, d, masking.CAUSAL)}
    for label, hq_, hkv_, inter, mask in MHA_SMALL:
        out["multi_head"][label] = check_multi_head(
            rng, label, 2, hq_, hkv_, 300, 64, mask, inter)
    phase["dispatch_multi_head"] = time.perf_counter() - t
    t = time.perf_counter()
    with torch.inference_mode():
        out["static_errors"], out["static_launches"] = check_static_max_all(
            rng)
    phase["dispatch_static_max"] = time.perf_counter() - t
    t = time.perf_counter()
    with torch.inference_mode():
        out["calibration"] = calibrate_gemms(rng)
    phase["dispatch_calibration"] = time.perf_counter() - t
    t = time.perf_counter()
    with torch.inference_mode():
        out["benchmark"] = run_benchmark()
    phase["dispatch_benchmark"] = time.perf_counter() - t
    t = time.perf_counter()
    with torch.inference_mode():
        out["times"] = time_static_max(rng)
    phase["dispatch_times"] = time.perf_counter() - t
    return out, phase

# --------------------------------------------------------------------------
# Phase 15: MLA training
# --------------------------------------------------------------------------

# MLAConfig()'s train step: 2 sequences of 2048 tokens (2 x 2049 with the
# targets), 8 Adam steps; each step runs one flash forward, dQ and dK/dV
# per layer at D = d_c + d_r = 288 (16 query heads over the latent).
MLA_TRAIN_BATCH, MLA_TRAIN_SEQ, MLA_TRAIN_STEPS = 2, 2048, 8
# The checkpoint check: save after this many steps, then run this many more
# from the saved state and from the restored one.
MLA_CKPT_STEPS = (3, 2)


def mla_train_tokens(cfg, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (MLA_TRAIN_BATCH, MLA_TRAIN_SEQ + 1))).to(DEV)


def mla_adam(cfg, params):
    """Adam at lr 3e-3 over ``params`` and its step of ``mla_loss_fn``."""
    optimizer = torch.optim.Adam(trainable_parameters(params), lr=3e-3)
    return optimizer, make_train_step(cfg, optimizer, loss=mla_loss_fn)


def check_mla_train_grads(cfg, params, rng):
    """(a) fp32 copies of the MLA weights at B=1, S=1024: every
    parameter's gradient of ``mla_loss_fn`` through the flash kernels
    (D = 288, fp32) against the same call with ``attn_fn=
    plain_mla_attention`` (no kernel); raises past GRAD_REL_L2_TOL."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = fp32_copy(params)
    leaves = trainable_parameters(params32)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, 1025))).to(DEV)
    grads, losses = {}, {}
    for name, attn in (("kernels", None), ("plain", plain_mla_attention)):
        for t in leaves:
            t.grad = None
        loss = mla_loss_fn(params32, tokens, cfg32, attn_fn=attn)
        loss.backward()
        grads[name] = [t.grad.detach().clone() for t in leaves]
        losses[name] = loss.item()
    worst = max(rel_l2(g, p) for g, p in zip(grads["kernels"],
                                             grads["plain"]))
    log(f"MLA fp32 grads (B=1, S=1024): loss kernels {losses['kernels']:.6f}"
        f" plain {losses['plain']:.6f}; worst parameter rel L2 {worst:.3e} "
        f"(tol {GRAD_REL_L2_TOL})")
    if not worst <= GRAD_REL_L2_TOL:
        raise AssertionError(f"MLA fp32 gradients disagree: {worst}")
    return worst


def run_mla_train(cfg, params, tokens):
    """(b) 8 Adam steps of ``mla_loss_fn`` on the bf16 model, the flash
    kernels' counts set to 0 just before and read after every step →
    (launches per step, ms a step and tokens/s over steps 2-8, losses, the
    host's span of each of steps 2-8 in ms: from the call of ``step`` until
    it returns with its launches enqueued, before the synchronize)."""
    optimizer, step = mla_adam(cfg, params)
    per_step, losses, host_ms = [], [], []
    zero_flash_counts()
    t_first, t0 = 0.0, time.perf_counter()
    for i in range(MLA_TRAIN_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
        before = flash_counts()
        merges = fbwd.merge_dkv_splits.launches
        t_step = time.perf_counter()
        params, _, loss = step(params, optimizer.state, tokens)
        if i:
            host_ms.append((time.perf_counter() - t_step) * 1e3)
        torch.cuda.synchronize()
        per_step.append({k: v - before[k] for k, v in flash_counts().items()})
        per_step[-1]["flash_dkv_merge"] = (fbwd.merge_dkv_splits.launches
                                           - merges)
        losses.append(loss.item())
    wall = time.perf_counter() - t0
    ms = wall / (MLA_TRAIN_STEPS - 1) * 1e3
    tps = (MLA_TRAIN_STEPS - 1) * MLA_TRAIN_BATCH * MLA_TRAIN_SEQ / wall
    log("MLA train losses: " + json.dumps(losses))
    log(f"MLA train: first step {t_first:.3f} s; steps 2-{MLA_TRAIN_STEPS} "
        f"{wall:.3f} s, {ms:.1f} ms/step, {tps:.0f} tokens/s; the host's "
        f"span of each step (ms) {json.dumps(host_ms)}; launches per step "
        f"{json.dumps(per_step[0])}")
    splits = fbwd.dkv_splits(cfg.dtype, cfg.latent_dim + cfg.rope_dim,
                             MLA_TRAIN_BATCH, cfg.num_heads, 1,
                             MLA_TRAIN_SEQ, sm_count())
    want = {"flash_fwd": cfg.num_layers, "flash_dq": cfg.num_layers,
            "flash_dkv": cfg.num_layers,
            "flash_dkv_merge": cfg.num_layers if splits > 1 else 0}
    if any(s != want for s in per_step):
        raise AssertionError(f"MLA train steps launched {per_step}, "
                             f"expected {want} each")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"MLA training did not lower the loss: "
                             f"{losses}")
    return per_step[0], ms, tps, losses, host_ms


def profile_mla_steps(cfg, params, tokens, steps=3):
    """(b) Where (b)'s step time goes, in this process: on a copy of
    ``params``, after one step to warm up, ``steps`` steps under the
    profiler, each fenced by a synchronize as (b)'s are → {"wall_ms": the
    profiled wall time a step, "host_ms": the host's span of each step's
    call, "device_busy_ms": the device's busy time a step (its kernels'
    and copies' time summed; not the host's annotated regions, which span
    kernels), "device_idle_share": 1 - busy / wall, "device_ms_by_kernel":
    a step's device ms by ``kernel_label``, the 12 largest}; busy and idle
    None where the profiler recorded no device time."""
    state = {"params": clone_params(params)}
    optimizer, step = mla_adam(cfg, state["params"])

    def run():
        t0 = time.perf_counter()
        state["params"], _, _ = step(state["params"], optimizer.state,
                                     tokens)
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return host

    run()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        host_ms = [run() for _ in range(steps)]
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            key = kernel_label(e.key)
            by[key] = by.get(key, 0.0) + e.self_device_time_total / 1e3 / steps
    busy_ms = sum(by.values()) or None
    out = {"steps": steps, "wall_ms": wall_ms, "host_ms": host_ms,
           "device_busy_ms": busy_ms,
           "device_idle_share": busy_ms and 1.0 - busy_ms / wall_ms,
           "device_ms_by_kernel": dict(sorted(
               by.items(), key=lambda kv: -kv[1])[:12])}
    log("MLA train step profile (this process): " + json.dumps(out))
    del state, optimizer
    torch.cuda.empty_cache()
    return out


def time_mla_step_turns(cfg, params, tokens):
    """(b) With ``--parent``: the MLA train step (Adam, on a copy of
    ``params``) timed on the parent's kernels and on this checkout's in
    turns (parent, change, change, parent), 3 steps a turn after one more
    → {"ms": turns, "tokens_per_s": turns}; None without ``--parent``."""
    if PARENT["lib"] is None:
        return None
    state = {"params": clone_params(params)}
    optimizer, step = mla_adam(cfg, state["params"])

    def one():
        state["params"], _, _ = step(state["params"], optimizer.state,
                                     tokens)

    t = {}
    parent_turns("MLA train step (phase 15)", t, one, 3)
    turns = t["parent_turns_ms"]
    tps = {k: [MLA_TRAIN_BATCH * MLA_TRAIN_SEQ / (ms / 1e3) for ms in v]
           for k, v in turns.items()}
    log("MLA train step parent / change turns, tokens/s: " + json.dumps(tps))
    del state, optimizer
    torch.cuda.empty_cache()
    return {"ms": turns, "tokens_per_s": tps}


def check_mla_train_determinism(cfg, init, tokens, trained):
    """(c) The same 8 steps twice more from the initial parameters: equal
    bit for bit after every step, the final parameters equal (b)'s."""
    rows, final = train_twice(cfg, init, tokens, MLA_TRAIN_STEPS,
                              loss=mla_loss_fn)
    digests = (params_digest(final), params_digest(trained))
    differ = [r for r in rows if r["params_differ"] or r["grads_differ"]
              or r["losses"][0] != r["losses"][1]]
    log(f"MLA train determinism: two runs of {MLA_TRAIN_STEPS} steps equal "
        f"bit for bit after every step: {not differ}; final parameters "
        f"equal (b)'s: {digests[0] == digests[1]} (sha256 "
        f"{digests[0][:16]})")
    if differ or digests[0] != digests[1]:
        raise AssertionError(f"MLA training is not deterministic: "
                             f"{differ[:2]} {digests}")
    return {"steps": MLA_TRAIN_STEPS, "bitwise_equal": True,
            "params_sha256": digests[0]}


def check_mla_checkpoint(cfg, init, tokens):
    """(d) 3 steps, ``save_checkpoint`` (parameters and
    ``optimizer.state_dict()``), 2 more; then ``load_checkpoint`` into
    fresh parameters and a fresh optimizer and the same 2 steps: the two
    sets of parameters equal bit for bit."""
    params = clone_params(init)
    optimizer, step = mla_adam(cfg, params)
    with tempfile.TemporaryDirectory(prefix="mfa-ckpt-") as tmp:
        path = os.path.join(tmp, "mla.pt")
        for _ in range(MLA_CKPT_STEPS[0]):
            params, _, _ = step(params, optimizer.state, tokens)
        save_checkpoint(path, dict(params=params,
                                   opt=optimizer.state_dict()))
        mib = os.path.getsize(path) / 2**20
        try:
            save_checkpoint(path, {}, force=False)
            refused = False
        except FileExistsError:
            refused = True
        for _ in range(MLA_CKPT_STEPS[1]):
            params, _, _ = step(params, optimizer.state, tokens)
        fresh = clone_params(init)
        fresh_opt, _ = mla_adam(cfg, fresh)
        state = load_checkpoint(path, template=dict(
            params=fresh, opt=fresh_opt.state_dict()), device="cpu")
    resumed = state["params"]
    optimizer2, step2 = mla_adam(cfg, resumed)
    optimizer2.load_state_dict(state["opt"])
    for _ in range(MLA_CKPT_STEPS[1]):
        resumed, _, _ = step2(resumed, optimizer2.state, tokens)
    torch.cuda.synchronize()
    same = params_digest(resumed) == params_digest(params)
    log(f"MLA checkpoint: {MLA_CKPT_STEPS[0]} steps, save ({mib:.1f} MiB), "
        f"{MLA_CKPT_STEPS[1]} more, against a resume from the file: equal "
        f"bit for bit {same}; force=False refused to overwrite {refused}")
    if not (same and refused):
        raise AssertionError(f"MLA checkpoint resume: equal {same}, "
                             f"refused {refused}")
    return {"bitwise_equal": True, "file_mib": mib}


def run_mla_training(seed):
    """Phase 15 (a)-(d), inputs from a ninth generator (seed + 8) →
    (record, phase seconds)."""
    rng = np.random.default_rng(seed + 8)
    cfg = MLAConfig()
    params = init_mla_params(cfg, torch.Generator().manual_seed(seed + 8),
                             device=DEV)
    tokens = mla_train_tokens(cfg, seed + 8)
    out, phase = {}, {}
    t = time.perf_counter()
    out["grad_rel_l2_worst"] = check_mla_train_grads(cfg, params, rng)
    phase["mla_train_grads"] = time.perf_counter() - t
    t = time.perf_counter()
    init = clone_params(params)
    (out["launches_per_step"], out["ms_per_step"], out["tokens_per_s"],
     out["losses"], out["host_ms_per_step"]) = run_mla_train(cfg, params,
                                                             tokens)
    out["step_profile"] = profile_mla_steps(cfg, params, tokens)
    phase["mla_train"] = time.perf_counter() - t
    out["step_turns"] = time_mla_step_turns(cfg, params, tokens)
    t = time.perf_counter()
    out["determinism"] = check_mla_train_determinism(cfg, init, tokens,
                                                     params)
    phase["mla_train_determinism"] = time.perf_counter() - t
    t = time.perf_counter()
    out["checkpoint"] = check_mla_checkpoint(cfg, init, tokens)
    phase["mla_checkpoint"] = time.perf_counter() - t
    return out, phase


# --------------------------------------------------------------------------
# Phase 16: context parallelism
# --------------------------------------------------------------------------

# A world of 4 ranks, each a process on the one card (cuda:0) under gloo
# (NCCL takes one rank per GPU); the ring's and Ulysses' collectives go
# through host memory there (parallel/comm.py).
CP_WORLD = 4
# (a)-(c): the flagship's attention over 4 x 2048 tokens (each rank holds
# the train step's 2048): B, Hq, Hkv, S, D, bf16.
CP_SHAPE = (1, 16, 4, CP_WORLD * TRAIN_SEQ, 64)
# (d): MLAConfig()'s latent attention without the rope slice: B, H, S,
# dh, d_c (the construction of tests/test_long_context.py:69).
CP_MLA = (1, 16, CP_WORLD * 2048, 64, 256)
# (e): fp32 at tests/test_parallel.py's shape, 256 rows a rank.
CP_SMALL = (1, 4, 2, CP_WORLD * 256, 64)


def cp_inputs(seed, b, hq, hkv, s, d, dtype):
    """Global Q, K, V, dO from a numpy generator: every rank draws the
    same numbers."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        DEV, dtype) for shape in ((b, hq, s, d), (b, hkv, s, d),
                                  (b, hkv, s, d), (b, hq, s, d))]


def cp_mla_inputs(seed):
    """(d)'s global inputs: bf16 queries [B, H, S, dh] and latent
    [B, S, d_c], fp32 W_uk [H, dh, d_c] and W_uv [H, d_c, dh]."""
    b, h, s, dh, dc = CP_MLA
    g = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(g.standard_normal(shape, np.float32)).to(DEV)

    q, latent = draw(b, h, s, dh).bfloat16(), draw(b, s, dc).bfloat16()
    w_uk, w_uv = draw(h, dh, dc), draw(h, dc, dh)
    return q, latent, w_uk * dc ** -0.5, w_uv * dc ** -0.5


def cp_run(fn, q, k, v, do=None):
    """``fn(q, k, v)`` and, with ``do``, its gradients → (o, grads, flash
    launches of the forward, of the backward, seconds)."""
    leaves = [x.detach().requires_grad_(do is not None) for x in (q, k, v)]
    t0 = time.perf_counter()
    zero_flash_counts()
    o = fn(*leaves)
    torch.cuda.synchronize()
    fwd = flash_counts()
    zero_flash_counts()
    grads = () if do is None else torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    return o.detach(), grads, fwd, flash_counts(), time.perf_counter() - t0


def cp_expect(kind, rank, world):
    """The flash launches a rank makes in each direction: the ring's
    non-empty steps (i + 1 causal, N full), the zigzag's 2N + 1 live
    sub-chunk pairs, Ulysses' one call."""
    return {"causal": rank + 1, "full": world, "zigzag": 2 * world + 1,
            "ulysses": 1}[kind]


def cp_case(rank, world, group, kind, q, k, v, do, interleaved=False):
    """One case on this rank's share of the global tensors → its local
    outputs on the host, launches and seconds; raises unless each
    direction launched exactly its steps."""
    c = q.shape[2] // world
    sl = slice(rank * c, (rank + 1) * c)
    if kind == "zigzag":
        q, k, v, do = (zigzag_preshard(x, world) for x in (q, k, v, do))
        fn = lambda a, b_, c_: ring_attention_zigzag(  # noqa: E731
            a, b_, c_, group, interleaved_kv=interleaved)
    elif kind == "ulysses":
        fn = lambda a, b_, c_: ulysses_attention(  # noqa: E731
            a, b_, c_, group, mask=masking.CAUSAL)
    else:
        fn = lambda a, b_, c_: ring_attention(  # noqa: E731
            a, b_, c_, group, kind == "causal", interleaved_kv=interleaved)
    o, grads, fwd, bwd, sec = cp_run(fn, *(x[:, :, sl] for x in (q, k, v,
                                                                 do)))
    n = cp_expect(kind, rank, world)
    want = ({"flash_fwd": n, "flash_dq": 0, "flash_dkv": 0},
            {"flash_fwd": 0, "flash_dq": n, "flash_dkv": n})
    if (fwd, bwd) != want:
        raise AssertionError(f"rank {rank} {kind}: launched {fwd} / {bwd}, "
                             f"expected {want}")
    return {"o": o, "grads": grads, "launches": [n, n, n], "seconds": sec}


def cp_rank_cases(rank, world, group, seed):
    """Every case of phase 16 on this rank → {case: local record}."""
    out = {}
    q, k, v, do = cp_inputs(seed, *CP_SHAPE, torch.bfloat16)
    for kind in ("causal", "full"):
        first = cp_case(rank, world, group, kind, q, k, v, do)
        again = cp_case(rank, world, group, kind, q, k, v, do)
        first["rerun_bitwise_equal"] = all(
            torch.equal(a, b) for a, b in zip(
                (first["o"], *first["grads"]), (again["o"], *again["grads"])))
        if not first["rerun_bitwise_equal"]:
            raise AssertionError(f"rank {rank} ring {kind}: a rerun differs")
        out[f"ring_{kind}"] = first
    out["zigzag"] = cp_case(rank, world, group, "zigzag", q, k, v, do)
    out["ulysses"] = cp_case(rank, world, group, "ulysses", q, k, v, do)
    mq, latent, w_uk, w_uv = cp_mla_inputs(seed + 1)
    dh, c = mq.shape[-1], mq.shape[2] // world
    sl = slice(rank * c, (rank + 1) * c)

    def mla_ring(q_):
        q_lat = torch.einsum("bhsd,hdc->bhsc", q_.float(), w_uk).to(q_.dtype)
        kv = latent[:, sl][:, None]
        o_lat = ring_attention(q_lat, kv, kv, group, True, dh ** -0.5)
        return torch.einsum("bhsc,hcd->bhsd", o_lat.float(), w_uv).to(
            q_.dtype)

    o, _, fwd, _, sec = cp_run(lambda q_, *_: mla_ring(q_), mq[:, :, sl],
                               latent, latent)
    if fwd != {"flash_fwd": rank + 1, "flash_dq": 0, "flash_dkv": 0}:
        raise AssertionError(f"rank {rank} MLA ring launched {fwd}")
    out["mla_ring"] = {"o": o, "grads": (), "launches": [rank + 1, 0, 0],
                       "seconds": sec}
    q, k, v, do = cp_inputs(seed + 2, *CP_SMALL, torch.float32)
    for kind, inter in (("causal", False), ("full", False), ("causal", True),
                        ("zigzag", False), ("ulysses", False)):
        name = f"fp32_{kind}" + ("_interleaved" if inter else "")
        out[name] = cp_case(rank, world, group, kind, q, k, v, do, inter)
    return {name: {**rec, "o": rec["o"].float().cpu(),
                   "grads": [x.float().cpu() for x in rec["grads"]]}
            for name, rec in out.items()}


def cp_reference(kind, q, k, v, do, interleaved=False):
    """The single-device ``flash_attention`` on the global tensors → (o,
    dq, dk, dv) on the host."""
    mask = masking.FULL if kind == "full" else masking.CAUSAL
    o, grads, _, _, _ = cp_run(lambda a, b_, c_: flash_attention(
        a, b_, c_, mask=mask, interleaved_kv=interleaved), q, k, v, do)
    return [x.float().cpu() for x in (o, *grads)]


def cp_gates(world, tmp, seed):
    """Rank 0, after every rank saved its outputs: each case gathered
    along the sequence against the single-device kernels on the same
    global inputs → {case: record}; raises past a gate."""
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
             for r in range(world)]
    q, k, v, do = cp_inputs(seed, *CP_SHAPE, torch.bfloat16)
    qs, ks, vs, dos = cp_inputs(seed + 2, *CP_SMALL, torch.float32)
    round_trip = all(torch.equal(zigzag_postshard(zigzag_preshard(
        x, world), world), x) for x in (q, k, v, do))
    refs = {"causal": cp_reference("causal", q, k, v, do),
            "full": cp_reference("full", q, k, v, do)}
    small = {(kind, inter): cp_reference(kind, qs, ks, vs, dos, inter)
             for kind, inter in (("causal", False), ("full", False),
                                 ("causal", True))}
    mq, latent, w_uk, w_uv = cp_mla_inputs(seed + 1)
    mla_ref = mla_absorbed_attention(mq, latent.float(), w_uk, w_uv,
                                     mask=masking.CAUSAL).float().cpu()
    cases = {  # case: (reference, tolerance, zigzag layout)
        "ring_causal": (refs["causal"], FLASH_TOL[torch.bfloat16], False),
        "ring_full": (refs["full"], FLASH_TOL[torch.bfloat16], False),
        "zigzag": (refs["causal"], FLASH_TOL[torch.bfloat16], True),
        "ulysses": (refs["causal"], FLASH_TOL[torch.bfloat16], False),
        "mla_ring": ([mla_ref], FLASH_TOL[torch.bfloat16], False),
        "fp32_causal": (small["causal", False], FLASH_TOL[torch.float32],
                        False),
        "fp32_full": (small["full", False], FLASH_TOL[torch.float32], False),
        "fp32_causal_interleaved": (small["causal", True],
                                    FLASH_TOL[torch.float32], False),
        "fp32_zigzag": (small["causal", False], FLASH_TOL[torch.float32],
                        True),
        "fp32_ulysses": (small["causal", False], FLASH_TOL[torch.float32],
                         False),
    }
    out, bad = {}, []
    for name, (ref, tol, zz) in cases.items():
        recs = [rk[name] for rk in ranks]
        got = [torch.cat([r[key] for r in recs], dim=2) for key in ("o",)]
        got += [torch.cat([r["grads"][i] for r in recs], dim=2)
                for i in range(len(recs[0]["grads"]))]
        if zz:
            got = [zigzag_postshard(x, world) for x in got]
        errs = dict(zip(("o", "dq", "dk", "dv"),
                        (rel_err(a, w) for a, w in zip(got, ref))))
        out[name] = {
            "errors": errs, "tol": tol,
            "launches_per_rank": [r["launches"] for r in recs],
            "wall_s_per_rank_time_shared": [r["seconds"] for r in recs],
            **({"rerun_bitwise_equal": all(r["rerun_bitwise_equal"]
                                           for r in recs)}
               if "rerun_bitwise_equal" in recs[0] else {})}
        log(f"context parallel {name}: errors vs the single-device kernels "
            f"{json.dumps(errs)} (tol {tol}); launches per rank (forward, "
            f"dQ, dK/dV) {json.dumps(out[name]['launches_per_rank'])}; wall "
            "s per rank (the ranks time-share one card: not a speed) "
            + json.dumps([round(x, 3) for x in
                          out[name]["wall_s_per_rank_time_shared"]]))
        if not all(e <= tol for e in errs.values()):
            bad.append((name, errs))
    out["zigzag_round_trip_exact"] = round_trip
    if bad or not round_trip:
        raise AssertionError(f"context parallelism disagrees: {bad}; "
                             f"zigzag round trip {round_trip}")
    return out


def cp_rank(rank, world, tmp, seed):
    """One rank of phase 16's world (a process of ``mp.spawn``): gloo over
    a FileStore in ``tmp``, the mesh's context group, every case; rank 0
    then gates the gathered results into ``tmp/result.json``."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "store"), world_size=world, rank=rank)
    try:
        group = make_mesh(1, 1, world).get_group(AXES.context)
        out = cp_rank_cases(rank, world, group, seed)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        res = cp_gates(world, tmp, seed)
        with open(os.path.join(tmp, "result.json"), "w") as f:
            json.dump(res, f)


def run_context_parallel(seed):
    """Phase 16, inputs from a tenth generator (seed + 9): the world of
    CP_WORLD ranks on the card; a rank's exception fails the phase (``mp.
    spawn`` raises it) → (record, phase seconds)."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mfa-cp-") as tmp:
        mp.spawn(cp_rank, args=(CP_WORLD, tmp, seed + 9), nprocs=CP_WORLD,
                 join=True)
        with open(os.path.join(tmp, "result.json")) as f:
            out = json.load(f)
    wall = time.perf_counter() - t
    log(f"context parallelism: {CP_WORLD} gloo ranks on cuda:0, every gate "
        f"passed; phase wall {wall:.1f} s (process start-up included; the "
        "ranks time-share one card)")
    return out, {"context_parallel": wall}


# --------------------------------------------------------------------------
# Phase 17: long context and the utilities
# --------------------------------------------------------------------------

# tests/test_long_context.py:112 (a TPU-only test there): B, H, S, dh, d_c,
# an int8 ROW CENTERED latent and a causal window of 4096.
LONG_SHAPE = (1, 8, 32768, 64, 256)
LONG_WINDOW = 4096
# The plain version's dense scores at S = 32768 would take 34 GB a
# temporary; it is held to the kernel at this length, same mask.
LONG_PLAIN_S = 8192


def run_long_context(rng):
    """(a) ``mla_absorbed_attention`` over the quantized latent with the
    window at S = 32768: one quantized-forward launch and a finite output;
    then the kernel against its plain version at S = LONG_PLAIN_S on the
    arguments the path builds."""
    b, h, s, dh, dc = LONG_SHAPE
    g = device_generator(rng)
    q = torch.randn((b, h, s, dh), generator=g, device=DEV).to(
        torch.bfloat16)
    latent = torch.randn((b, s, dc), generator=g, device=DEV)
    w_uk = torch.randn((h, dh, dc), generator=g, device=DEV) * dc ** -0.5
    w_uv = torch.randn((h, dc, dh), generator=g, device=DEV) * dc ** -0.5
    row8 = QuantConfig(granularity=QuantGranularity.ROW,
                       strategy=QuantStrategy.CENTERED)
    mask = masking.sliding_window(LONG_WINDOW, causal=True)
    c = quantize(latent[:, None], row8)
    qattn_fwd.launches = 0
    t0 = time.perf_counter()
    o = mla_absorbed_attention(q, c, w_uk, w_uv, mask=mask)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = qattn_fwd.launches
    finite = bool(torch.isfinite(o.float()).all())
    n = LONG_PLAIN_S
    cs = quantize(latent[:, None, :n], row8)
    q_lat = torch.einsum("bhsd,hdc->bhsc", q[:, :, :n].float(),
                         w_uk).to(q.dtype)
    args, kw = qattn_arguments(q_lat, cs, cs, mask=mask, scale=dh ** -0.5)
    tile = main_path_tile(kw, n)
    got = qattn_fwd(*args, **kw, kv_tile=tile)
    torch.cuda.synchronize()
    errs = check_pair(f"qattn_fwd {kw['mode'].k_scales} K, causal window "
                      f"{LONG_WINDOW}, Hq={h} over Hkv=1, D={dc}, S={n}",
                      got, qattn_fwd_plain(*args, **kw,
                                           kv_tile=tile or KV_TILE))
    log(f"long context (B={b} H={h} S={s} d_c={dc}, int8 ROW latent, window "
        f"{LONG_WINDOW}): qattn_fwd launches {launches}, output "
        f"{tuple(o.shape)} finite {finite}, {seconds:.3f} s (first call)")
    if launches != 1 or not finite or o.shape != (b, h, s, dh):
        raise AssertionError(f"long context: launches {launches}, finite "
                             f"{finite}, shape {tuple(o.shape)}")
    return {"launches": launches, "finite": finite, "seconds": seconds,
            "kernel_vs_plain_s8192": errs}


def check_serialization_on_card(rng):
    """(b) ``save_quantized`` then ``load_quantized`` of CUDA tensors
    (int8 ROW; int4 BLOCK 64 with sums): loaded onto the card by default,
    every field equal bit for bit."""
    g = device_generator(rng)
    x = torch.randn((64, 512), generator=g, device=DEV)
    out = {}
    for name, cfg in (("int8_row", QuantConfig(
            granularity=QuantGranularity.ROW)), ("int4_block64_sums",
            QuantConfig(bits=4, granularity=QuantGranularity.BLOCK,
                        block_size=64, compute_sums=True))):
        t = quantize(x.to(torch.bfloat16), cfg)
        buf = io.BytesIO()
        save_quantized(t, buf)
        buf.seek(0)
        back = load_quantized(buf)
        fields = ("data", "scale", "zero_point", "sums")
        same = all(torch.equal(getattr(back, f), getattr(t, f))
                   if getattr(t, f) is not None else getattr(back, f) is None
                   for f in fields) and (back.config, back.shape,
                                         back.orig_dtype) == (
            t.config, t.shape, t.orig_dtype)
        on_card = all(getattr(back, f).is_cuda for f in fields
                      if getattr(back, f) is not None)
        out[name] = {"bitwise_equal": same, "on_card": on_card,
                     "bytes": buf.getbuffer().nbytes}
        if not (same and on_card):
            raise AssertionError(f"serialization {name}: {out[name]}")
    log("save_quantized / load_quantized on the card: " + json.dumps(out))
    return out


def check_dump_lowered(rng):
    """(c) ``dump_lowered`` of ``flash_attention_forward`` on card inputs
    (the train step's attention shape): the file names
    ``flash_fwd_tc_kernel`` and holds its SASS."""
    b, hq, hkv, s, d = MHA_SHAPE
    q, k, v, _, _ = flash_inputs(rng, b, hq, hkv, s, s, d, torch.bfloat16)
    with tempfile.TemporaryDirectory(prefix="mfa-dump-") as tmp:
        path = dump_lowered(lambda q_, k_, v_: flash_attention_forward(
            q_, k_, v_, mask=masking.CAUSAL), q, k, v, name="flash_fwd",
            path=tmp)
        text = Path(path).read_text()
    heads = re.findall(r"^# Function : (\S*flash_fwd_tc_kernel\S*)$", text,
                       re.M)
    sass = len(re.findall(r"/\*[0-9a-f]{4,}\*/", text))
    out = {"functions": heads, "sass_lines": sass, "bytes": len(text),
           "graph": "aten" in text}
    log(f"dump_lowered(flash_attention_forward) on the card: {len(text)} "
        f"bytes, {len(heads)} flash_fwd_tc_kernel functions, {sass} SASS "
        "lines")
    if not (heads and sass > 100 and out["graph"]):
        raise AssertionError(f"dump_lowered: {out}; the file's header: "
                             + "".join(re.findall(r"^# .*\n", text, re.M)))
    return out


def run_long_context_and_utilities(seed):
    """Phase 17 (a)-(c), inputs from an eleventh generator (seed + 10) →
    (record, phase seconds)."""
    rng = np.random.default_rng(seed + 10)
    out, phase = {}, {}
    for key, fn in (("long_context", run_long_context),
                    ("serialization", check_serialization_on_card),
                    ("dump_lowered", check_dump_lowered)):
        t = time.perf_counter()
        with torch.inference_mode(key == "long_context"):
            out[key] = fn(rng)
        phase[key] = time.perf_counter() - t
    return out, phase


# --------------------------------------------------------------------------
# Phase 18: the 3D-parallel train step, expert and pipeline parallelism
# --------------------------------------------------------------------------

# A world of 4 gloo ranks on cuda:0, as phase 16's.  The flagship runs on
# the mesh (data, model, context) = (1, 2, 2) with ring attention: a rank
# holds half the heads, the MLP's width and the vocabulary, and half the
# sequence.  Every input comes from a twelfth generator (seed + 11).
SPMD = types.SimpleNamespace(
    world=4,
    mesh=(1, 2, 2),
    # (a) fp32 gradients at phase 15's B=1, S=1024.
    grad_cfg=dataclasses.replace(TransformerConfig(), dtype=torch.float32),
    grad_tokens=(1, 1025),
    # (b) the bf16 train step at phase 7's 4 x 2049 tokens, AdamW.
    train_cfg=TransformerConfig(),
    train_tokens=(TRAIN_BATCH, TRAIN_SEQ + 1),
    train_steps=3,
    # (c) the CPU tests' configuration (tests/test_torch_spmd.py), fp32.
    small_cfg=TransformerConfig(
        vocab_size=512, d_model=128, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=256, max_seq=256,
        dtype=torch.float32),
    small_tokens=(2, 257),
    small_meshes={"ring_2x1x2": ((2, 1, 2), "ring"),
                  "ulysses_1x2x2": ((1, 2, 2), "ulysses"),
                  "local_2x2x1": ((2, 2, 1), "local")},
    # (d) MoE: d_model, d_ff, experts (2 a rank), top-k, tokens a rank;
    # capacity_factor = experts / top-k, so no expert can overflow.
    moe=(1024, 4096, 8, 2, 1024),
    # (d) pipeline: d, microbatches, rows a microbatch (4 tanh stages).
    pipe=(1024, 8, 16),
    dev=DEV,
)
SPMD_LOSS_TOL = 2e-2  # (b): step 0's loss vs the single-device bf16 loss
# (b) against the single-device bf16 step: every step's loss (rel) and the
# update of all the parameters over the 3 steps (rel L2).  On an H100 80GB
# HBM3 at 700 W the sharded step reads 5.7e-4 and 9.8e-2, and the same step
# with its gradients left unsynced over the context axis 6.4e-2 and 0.82.
SPMD_TRAIN_LOSS_TOL = 3e-3
SPMD_UPDATE_TOL = 0.3
SPMD_SMALL_TOL = 1e-4  # (c): rel L2 of the loss, gradients and logits
MOE_TOL = 1e-4  # (d): max abs over the reference's max abs
PIPE_TOL = 1e-5


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def flat_tree(tree) -> dict:
    """A parameter (or gradient) tree as {"embed": t, "layers.0.ln1": t,
    ...} in ``named_parameters``' order."""
    out = {"embed": tree["embed"]}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in sorted(layer.items())})
    out.update(ln_f=tree["ln_f"], unembed=tree["unembed"])
    return out


def sha256_of(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().view(
        torch.uint8).numpy().tobytes()).hexdigest()


def spmd_tokens(cfg, shape, seed, dev):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape)).to(dev)


def spmd_normal(seed, shape, dev, scale=1.0):
    g = np.random.default_rng(seed)
    return torch.from_numpy((g.standard_normal(shape) * scale).astype(
        np.float32)).to(dev)


def cpu_tree(tree) -> dict:
    """A parameter (or gradient) tree's tensors copied to the host."""
    return {"embed": tree["embed"].detach().cpu(),
            "layers": [{k: v.detach().cpu() for k, v in layer.items()}
                       for layer in tree["layers"]],
            "ln_f": tree["ln_f"].detach().cpu(),
            "unembed": tree["unembed"].detach().cpu()}


def spmd_expect(cfg, mesh, dev) -> dict:
    """The flash launches a rank makes in each direction of one step: a
    ring step a layer for every earlier context chunk and the diagonal (8
    at context position 0, 16 at 1); none on the CPU (the plain
    versions)."""
    n = cfg.num_layers * (mesh.get_local_rank(AXES.context) + 1)
    n = n if dev.type == "cuda" else 0
    return {"flash_fwd": n, "flash_dq": n, "flash_dkv": n}


def spmd_grads_rank(mesh, spec, seed):
    """(a) on this rank: the loss and its gradient shards (the full ones
    on the context-0 ranks, digests on all), launches, seconds."""
    cfg, dev = spec.grad_cfg, spec.dev
    sc = ShardingConfig(attn_mode="ring")
    local = shard_params(init_params(
        cfg, torch.Generator().manual_seed(seed), device=dev), mesh, cfg, sc)
    tokens = spmd_tokens(cfg, spec.grad_tokens, seed, dev)
    fn = make_spmd_loss_and_grad(cfg, mesh, sc)
    sync(dev)
    zero_flash_counts()
    t0 = time.perf_counter()
    loss, grads = fn(local, tokens[:, :-1], tokens[:, 1:])
    sync(dev)
    sec, launches = time.perf_counter() - t0, flash_counts()
    want = spmd_expect(cfg, mesh, dev)
    if launches != want:
        raise AssertionError(f"SPMD fp32 gradient launched {launches}, "
                             f"expected {want}")
    grads = cpu_tree(grads)
    rec = {"loss": loss.item(), "launches": launches, "seconds": sec,
           "sha256": {k: sha256_of(v) for k, v in flat_tree(grads).items()}}
    if mesh.get_local_rank(AXES.context) == 0:
        rec["grads"] = grads
    return rec


def spmd_train_rank(mesh, spec, seed):
    """(b) on this rank: the bf16 flagship's sharded train step, twice
    from the same parameters; raises unless every step launched exactly
    its ring steps.  The flash launches read after each step of the first
    run are returned, and the final shards from the (data 0, context 0)
    ranks."""
    cfg, dev = spec.train_cfg, spec.dev
    sc = ShardingConfig(attn_mode="ring")
    init = shard_params(init_params(
        cfg, torch.Generator().manual_seed(seed), device=dev), mesh, cfg, sc)
    tokens = spmd_tokens(cfg, spec.train_tokens, seed, dev)
    want = spmd_expect(cfg, mesh, dev)

    def run():
        params = clone_params(init)
        optimizer = torch.optim.AdamW(trainable_parameters(params), lr=3e-3,
                                      weight_decay=1e-4)
        step = make_spmd_train_step(cfg, mesh, optimizer, sc)
        losses, walls, counts = [], [], []
        for i in range(spec.train_steps):
            sync(dev)
            zero_flash_counts()
            t0 = time.perf_counter()
            params, _, loss = step(params, optimizer.state, tokens)
            losses.append(loss.item())
            sync(dev)
            walls.append(time.perf_counter() - t0)
            counts.append(flash_counts())
            if counts[-1] != want:
                raise AssertionError(f"SPMD train step {i + 1} launched "
                                     f"{counts[-1]}, expected {want}")
        return losses, walls, counts, params

    (losses, walls, counts, final), (losses2, walls2, _, final2) = (run(),
                                                                    run())
    digest, digest2 = params_digest(final), params_digest(final2)
    rec = {"losses": losses, "rerun_losses": losses2,
           "wall_s_per_step": walls, "rerun_wall_s_per_step": walls2,
           "launches_per_step": counts, "params_sha256": digest,
           "rerun_bitwise_equal": losses == losses2 and digest == digest2}
    if (mesh.get_local_rank(AXES.data), mesh.get_local_rank(AXES.context)
            ) == (0, 0):
        rec["final"] = cpu_tree(final)
    return rec


def spmd_small_rank(spec, seed):
    """(c) on this rank: each small mesh's loss and gradient shards, and
    ``spmd_forward``'s global logits on the ring mesh."""
    cfg, dev = spec.small_cfg, spec.dev
    full = init_params(cfg, torch.Generator().manual_seed(seed), device=dev)
    tokens = spmd_tokens(cfg, spec.small_tokens, seed, dev)
    out = {}
    for case, (shape, mode) in spec.small_meshes.items():
        mesh = make_mesh(*shape, device_type=dev.type)
        sc = ShardingConfig(attn_mode=mode)
        local = shard_params(full, mesh, cfg, sc)
        loss, grads = make_spmd_loss_and_grad(cfg, mesh, sc)(
            local, tokens[:, :-1], tokens[:, 1:])
        out[case] = {"loss": loss.item(), "grads": cpu_tree(grads)}
        if mode == "ring":
            out[case]["logits"] = spmd_forward(local, tokens[:, :-1], cfg,
                                               mesh, sc).cpu()
    return out


def moe_inputs(spec, seed, world):
    d, f, e, _, t = spec.moe
    full = init_moe_params(torch.Generator().manual_seed(seed), d, f, e,
                           device=spec.dev)
    return full, spmd_normal(seed, (world * t, d), spec.dev)


def pipe_inputs(spec, seed, world):
    d, n_micro, rows = spec.pipe
    return (spmd_normal(seed, (world, d, d), spec.dev, d ** -0.5),
            spmd_normal(seed + 1, (n_micro, rows, d), spec.dev))


def pipe_stage(w, x):
    return torch.tanh(x @ w)


def moe_pipe_rank(rank, world, spec, seed):
    """(d) on this rank: the MoE layer over its tokens and its experts
    (output, the router's gradient summed over the ranks, wd's), and the
    pipeline's output and stage gradient without and with remat."""
    _, _, e, k, t = spec.moe
    full, x = moe_inputs(spec, seed, world)
    el = e // world
    local = {n: (v if n == "router" else v[rank * el:(rank + 1) * el])
             .clone().requires_grad_(True) for n, v in full.items()}
    y = moe_ffn(local, x[rank * t:(rank + 1) * t], top_k=k,
                capacity_factor=e / k)
    g_router, g_wd = torch.autograd.grad((y * y).sum(),
                                         [local["router"], local["wd"]])
    out = {"moe": {"out": y.detach().cpu(),
                   "router_grad": all_reduce(g_router).cpu(),
                   "wd_grad": g_wd.cpu()}}
    ws, xs = pipe_inputs(spec, seed, world)
    for remat in (False, True):
        w = ws[rank].clone().requires_grad_(True)
        o = broadcast_from_last_stage(pipeline_apply(pipe_stage, w, xs,
                                                     remat=remat))
        (g,) = torch.autograd.grad((o * o).sum(), [w])
        out[f"pipe_remat_{remat}"] = {"out": o.detach().cpu(),
                                      "grad": g.cpu()}
    return out


def spmd_gate_grads(ranks, spec, seed):
    """(a) on rank 0: the replicas' digests equal, the loss the same on
    every rank, the gathered gradients against the single-device
    ``loss_fn`` on the card."""
    cfg, dev, shape = spec.grad_cfg, spec.dev, spec.mesh
    recs = [r["grads"] for r in ranks]
    shards = {m: recs[mesh_rank((0, m, 0), shape)]["grads"]
              for m in range(shape[1])}
    replicas_equal = all(
        recs[mesh_rank((d, m, c), shape)]["sha256"]
        == recs[mesh_rank((0, m, 0), shape)]["sha256"]
        for d in range(shape[0]) for m in range(shape[1])
        for c in range(shape[2]))
    got = flat_tree(unshard_params(shards, cfg))
    del shards
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device=dev)
    named = named_parameters(params)
    loss = loss_fn(params, spmd_tokens(cfg, spec.grad_tokens, seed, dev),
                   cfg)
    loss.backward()
    errs = {n: rel_l2(got[n].to(dev), t.grad) for n, t in named}
    losses = {r["loss"] for r in recs}
    loss_err = abs(recs[0]["loss"] - loss.item()) / abs(loss.item())
    worst = max(errs.values())
    log(f"SPMD (a) fp32 flagship gradients on mesh {shape} ring, B=1 "
        f"S={spec.grad_tokens[1] - 1}: loss {recs[0]['loss']:.6f} vs the "
        f"single device {loss.item():.6f} (rel {loss_err:.3e}); worst "
        f"parameter rel L2 {worst:.3e} ({max(errs, key=errs.get)}; tol "
        f"{GRAD_REL_L2_TOL}); replicas equal bit for bit {replicas_equal}; "
        f"launches per rank {json.dumps([r['launches'] for r in recs])}")
    if not (worst <= GRAD_REL_L2_TOL and loss_err <= GRAD_REL_L2_TOL
            and len(losses) == 1 and replicas_equal):
        raise AssertionError(f"SPMD fp32 gradients: worst {worst}, loss "
                             f"{loss_err}, losses {losses}, replicas "
                             f"{replicas_equal}")
    return {"grad_rel_l2_worst": worst, "loss_rel_err": loss_err,
            "replicas_bitwise_equal": True,
            "launches_per_rank": [r["launches"] for r in recs],
            "seconds_per_rank": [r["seconds"] for r in recs]}


def spmd_gate_train(ranks, spec, seed):
    """(b) on rank 0: the sharded run against the single-device bf16
    ``make_train_step`` with the same AdamW from the same parameters:
    each step's loss, and each parameter's update over the run (the
    final shards gathered, less the initial parameters); step 0's loss
    within ``SPMD_LOSS_TOL``, the losses finite and falling and the same
    on every rank; a rerun equal bit for bit (else, reported, equal
    losses across the model ranks)."""
    cfg, dev, shape = spec.train_cfg, spec.dev, spec.mesh
    recs = [r["train"] for r in ranks]
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device=dev)
    init = clone_params(params)
    optimizer = torch.optim.AdamW(trainable_parameters(params), lr=3e-3,
                                  weight_decay=1e-4)
    step = make_train_step(cfg, optimizer)
    tokens = spmd_tokens(cfg, spec.train_tokens, seed, dev)
    ref = []
    for _ in range(spec.train_steps):
        params, _, loss = step(params, optimizer.state, tokens)
        ref.append(loss.item())
    got = flat_tree(unshard_params(
        {m: recs[mesh_rank((0, m, 0), shape)]["final"]
         for m in range(shape[1])}, cfg))
    init = flat_tree(init)
    sq = {}  # name: (|sharded update - single update|^2, |single update|^2)
    for n, t in named_parameters(params):
        want = t.detach().float() - init[n].float()
        diff = got[n].to(dev).float() - init[n].float() - want
        sq[n] = (diff.square().sum().item(), want.square().sum().item())
    del got, init, params, optimizer
    updates = {n: (a / b) ** 0.5 for n, (a, b) in sq.items()}
    update_all = (sum(a for a, _ in sq.values())
                  / sum(b for _, b in sq.values())) ** 0.5
    losses = recs[0]["losses"]
    loss_errs = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    update_worst = max(updates.values())
    same = all(r["losses"] == losses for r in recs)
    bitwise = all(r["rerun_bitwise_equal"] for r in recs)
    model_equal = all(
        recs[mesh_rank((d, m, c), shape)]["rerun_losses"]
        == recs[mesh_rank((d, 0, c), shape)]["rerun_losses"]
        for d in range(shape[0]) for m in range(shape[1])
        for c in range(shape[2]))
    rerun_gate = bitwise or model_equal
    walls = [r["wall_s_per_step"] for r in recs]
    launches = [[list(c.values()) for c in r["launches_per_step"]]
                for r in recs]
    log(f"SPMD (b) bf16 flagship train step on mesh {shape} ring, "
        f"{spec.train_tokens[0]} x {spec.train_tokens[1]} tokens, AdamW: "
        f"losses {json.dumps(losses)}, the single device's "
        f"{json.dumps(ref)}: rel {json.dumps(loss_errs)} (step 0 tol "
        f"{SPMD_LOSS_TOL}, every step {SPMD_TRAIN_LOSS_TOL}); the update "
        f"over the run, rel L2 over every parameter {update_all:.3e} (tol "
        f"{SPMD_UPDATE_TOL}), worst parameter {update_worst:.3e} "
        f"({max(updates, key=updates.get)}; not gated: a bf16 norm weight "
        f"near 1 takes Adam's small steps in rounding jumps); the "
        f"same on every rank {same}; rerun equal bit for bit {bitwise}"
        + ("" if bitwise else f" (NOT: gated on equal losses across the "
           f"model ranks instead, {model_equal})")
        + "; flash launches read after each step per rank (forward, dQ, "
        "dK/dV) " + json.dumps(launches)
        + "; wall s per step per rank (4 ranks time-share one card: not a "
        "speed) " + json.dumps([[round(x, 3) for x in w] for w in walls]))
    if not (loss_errs[0] <= SPMD_LOSS_TOL
            and max(loss_errs) <= SPMD_TRAIN_LOSS_TOL
            and update_all <= SPMD_UPDATE_TOL and same and rerun_gate
            and all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"SPMD train step: losses {losses}, ref {ref}, "
                             f"update {update_all}, same {same}, "
                             f"rerun {bitwise}/{model_equal}")
    return {"losses": losses, "single_device_losses": ref,
            "loss_rel_errs": loss_errs, "update_rel_l2": update_all,
            "update_rel_l2_per_parameter": updates,
            "rerun_bitwise_equal": bitwise,
            "rerun_gate": "bitwise" if bitwise else "model_ranks_equal",
            "launches_per_step_per_rank": [r["launches_per_step"]
                                           for r in recs],
            "wall_s_per_step_per_rank_time_shared": walls,
            "params_sha256_per_rank": [r["params_sha256"] for r in recs]}


def spmd_gate_small(ranks, spec, seed):
    """(c) on rank 0: each small mesh's loss, gathered gradients (the
    replicas equal bit for bit) and the ring mesh's logits against the
    single device on the card."""
    cfg, dev = spec.small_cfg, spec.dev
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device=dev)
    named = named_parameters(params)
    tokens = spmd_tokens(cfg, spec.small_tokens, seed, dev)
    loss = loss_fn(params, tokens, cfg)
    loss.backward()
    with torch.no_grad():
        logits = forward(params, tokens[:, :-1], cfg)
    out, bad = {}, []
    for case, (shape, _) in spec.small_meshes.items():
        recs = [r["small"][case] for r in ranks]
        flats = [flat_tree(r["grads"]) for r in recs]
        replicas = all(
            torch.equal(flats[mesh_rank((d, m, c), shape)][n],
                        flats[mesh_rank((0, m, 0), shape)][n])
            for d in range(shape[0]) for m in range(shape[1])
            for c in range(shape[2]) for n, _ in named)
        got = flat_tree(unshard_params(
            {m: recs[mesh_rank((0, m, 0), shape)]["grads"]
             for m in range(shape[1])}, cfg))
        errs = {"loss": abs(recs[0]["loss"] - loss.item()) / loss.item(),
                "grads_worst": max(rel_l2(got[n].to(dev), t.grad)
                                   for n, t in named)}
        if "logits" in recs[0]:
            errs["logits"] = max(rel_l2(r["logits"].to(dev), logits)
                                 for r in recs)
        same = len({r["loss"] for r in recs}) == 1
        out[case] = {"rel_errors": errs, "replicas_bitwise_equal": replicas}
        log(f"SPMD (c) small fp32 {case}: rel errors vs the single device "
            f"{json.dumps(errs)} (tol {SPMD_SMALL_TOL}); replicas equal "
            f"{replicas}; one loss on every rank {same}")
        if not (max(errs.values()) <= SPMD_SMALL_TOL and replicas and same):
            bad.append(case)
    if bad:
        raise AssertionError(f"SPMD small meshes disagree: {bad}")
    return out


def spmd_gate_moe_pipe(ranks, spec, seed):
    """(d) on rank 0: the MoE outputs and gradients against
    ``moe_ffn_dense_reference`` per rank's tokens (its summed loss
    differentiated), the pipeline against the sequential stages."""
    world = len(ranks)
    _, _, e, k, t = spec.moe
    full, x = moe_inputs(spec, seed, world)
    ref = {n: v.clone().requires_grad_(True) for n, v in full.items()}
    ys = [moe_ffn_dense_reference(ref, x[r * t:(r + 1) * t], top_k=k)
          for r in range(world)]
    g_router, g_wd = torch.autograd.grad(sum((y * y).sum() for y in ys),
                                         [ref["router"], ref["wd"]])
    el = e // world
    moe = {"out": max(rel_err(ranks[r]["moe"]["out"], ys[r].detach().cpu())
                      for r in range(world)),
           "router_grad": max(rel_err(rk["moe"]["router_grad"],
                                      g_router.cpu()) for rk in ranks),
           "wd_grad": max(rel_err(ranks[r]["moe"]["wd_grad"],
                                  g_wd[r * el:(r + 1) * el].cpu())
                          for r in range(world))}
    ws, xs = pipe_inputs(spec, seed, world)
    ws = ws.clone().requires_grad_(True)
    outs = []
    for xm in xs:  # the stages one after another, a microbatch at a time
        for w in ws:
            xm = pipe_stage(w, xm)
        outs.append(xm)
    seq = torch.stack(outs)
    (g_ws,) = torch.autograd.grad((seq * seq).sum(), [ws])
    pipe = {f"{key}_{part}": max(
        rel_err(rk[key][part], (seq if part == "out" else g_ws[r]).detach()
                .cpu()) for r, rk in enumerate(ranks))
        for key in ("pipe_remat_False", "pipe_remat_True")
        for part in ("out", "grad")}
    log(f"SPMD (d) MoE, {e} experts over {world} ranks, top-{k}, {t} tokens "
        f"a rank, d_model {spec.moe[0]}, d_ff {spec.moe[1]}: max abs over "
        f"the dense reference's {json.dumps(moe)} (tol {MOE_TOL}); "
        f"pipeline, {world} stages of tanh(x @ w), d {spec.pipe[0]}, "
        f"{spec.pipe[1]} x {spec.pipe[2]} rows: vs the sequential stages "
        f"{json.dumps(pipe)} (tol {PIPE_TOL})")
    if not (max(moe.values()) <= MOE_TOL and max(pipe.values()) <= PIPE_TOL):
        raise AssertionError(f"MoE {moe} / pipeline {pipe} disagree")
    return {"moe_rel_err": moe, "pipeline_rel_err": pipe}


def spmd_rank(rank, world, tmp, seed, spec):
    """One rank of phase 18's world (a process of ``mp.spawn``): gloo over
    a FileStore in ``tmp``, parts (a)-(d); rank 0 then gates the gathered
    results into ``tmp/result.json``."""
    if spec.dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "store"), world_size=world, rank=rank)
    try:
        mesh = make_mesh(*spec.mesh, device_type=spec.dev.type)
        out, seconds = {}, {}
        for key, fn in (
                ("grads", lambda: spmd_grads_rank(mesh, spec, seed)),
                ("train", lambda: spmd_train_rank(mesh, spec, seed)),
                ("small", lambda: spmd_small_rank(spec, seed)),
                ("moe_pipe", lambda: moe_pipe_rank(rank, world, spec,
                                                   seed))):
            t = time.perf_counter()
            out[key] = fn()
            seconds[key] = time.perf_counter() - t
        out.update(out.pop("moe_pipe"))
        out["seconds"] = seconds
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=True) for r in range(world)]
        res = {"part_seconds_per_rank": [r["seconds"] for r in ranks]}
        for key, gate in (("grads", spmd_gate_grads),
                          ("train", spmd_gate_train),
                          ("small", spmd_gate_small),
                          ("moe_pipeline", spmd_gate_moe_pipe)):
            t = time.perf_counter()
            res[key] = gate(ranks, spec, seed)
            res["part_seconds_per_rank"][0][f"gate_{key}"] = (
                time.perf_counter() - t)
        with open(os.path.join(tmp, "result.json"), "w") as f:
            json.dump(res, f)


def run_dryrun(n):
    """(e): ``dryrun_multichip(n)`` on the card → its three lines; raises
    unless they are the JAX dry run's."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(n)
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(line)
    want = ("dryrun_multichip OK: mesh(", f"dryrun EP OK: {n} ",
            f"dryrun PP OK: {n} ")
    if len(lines) != 3 or not all(a.startswith(b)
                                  for a, b in zip(lines, want)):
        raise AssertionError(f"dryrun_multichip printed {lines}")
    return lines


def run_spmd(seed, spec=SPMD):
    """Phase 18, inputs from a twelfth generator (seed + 11): (a)-(d) in
    the world of ``spec.world`` ranks, then (e) the dry run; a rank's
    exception fails the phase (``mp.spawn`` raises it) → (record, phase
    seconds)."""
    phase = {}
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mfa-spmd-") as tmp:
        mp.spawn(spmd_rank, args=(spec.world, tmp, seed + 11, spec),
                 nprocs=spec.world, join=True)
        with open(os.path.join(tmp, "result.json")) as f:
            out = json.load(f)
    phase["spmd_world"] = time.perf_counter() - t
    log("SPMD part seconds per rank (the ranks time-share one card): "
        + json.dumps([{k: round(v, 2) for k, v in r.items()}
                      for r in out["part_seconds_per_rank"]]))
    t = time.perf_counter()
    out["dryrun_lines"] = run_dryrun(spec.world)
    phase["spmd_dryrun"] = time.perf_counter() - t
    log(f"3D-parallel train step, EP and PP: {spec.world} gloo ranks on "
        f"cuda:0, every gate passed; world {phase['spmd_world']:.1f} s, dry "
        f"run {phase['spmd_dryrun']:.1f} s (process start-up included)")
    return out, phase


# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# Phase 19: the quantized attention at MLA's width
# --------------------------------------------------------------------------

# MLA's absorbed width: the joint [C | K_rope] latent, d_c + d_r = 256 + 32
# lanes (272 runs zero-padded at 288).
MLA_QD = MLA_D
# The record entries of the kernels this phase adds, and the device kernel
# each launches at MLA's shape (the full-integer pair's D = 288 instances
# of fullint_dq_tc_kernel / fullint_dkv_tc_kernel).
WIDE_QKERNELS = {
    "qattn_fwd_wide": ("qattn_fwd", "qattn_fwd_wide_kernel",
                       f"{QATTN_TPU}:87", QATTN_SOURCE),
    "qflash_dq_wide": ("qflash_dq", "qflash_dq_wide_kernel",
                       f"{FLASH_BWD_TPU}:77", QBWD_SOURCE),
    "qflash_dkv_wide": ("qflash_dkv", "qflash_dkv_wide_kernel",
                        f"{FLASH_BWD_TPU}:954", QBWD_SOURCE),
    "fullint_dq_d288": ("fullint_dq", "fullint_dq_tc_kernel",
                        f"{FLASH_BWD_TPU}:511", QBWD_SOURCE),
    "fullint_dkv_d288": ("fullint_dkv", "fullint_dkv_tc_kernel",
                         f"{FLASH_BWD_TPU}:584", QBWD_SOURCE),
}
WIDE_QREDESIGNED = {
    "qattn_fwd_wide": "qattn_fwd_tc_kernel's body at D = 288 in 32-key "
                      "steps (S at 16 registers beside O's 144), payload "
                      "bytes double-buffered by cp.async and dequantized in "
                      "shared memory, 113,664 bytes (bf16 Q), two CTAs an "
                      "SM; an int8 P walks the TPU's block_kv spans twice",
    "qflash_dq_wide": "dq_wide_body over the payload: 32-key tiles of "
                      "payload rows double-buffered by cp.async, dequantized "
                      "into one bf16 tile each, the folded column scales "
                      "and store multipliers, 8 warps",
    "qflash_dkv_wide": "dkv_wide_body over the payload: K and V dequantized "
                       "once into resident bf16 tiles, 48-row Q / dO steps, "
                       "12 warps, the GQA group dealt over dkv_splits CTAs "
                       "and summed in split order by flash_dkv_merge_kernel",
    "fullint_dq_d288": "fullint_dq_tc_kernel at D = 288: two warp groups "
                       "(144 lanes a warp), S and dP summed from 0 in int32 "
                       "(|S| may pass 2^22)",
    "fullint_dkv_d288": "fullint_dkv_tc_kernel at D = 288: two warp groups, "
                        "level 1 in 32-query steps (146,688 B; 64-query "
                        "steps would take 252,416, past the 232,448 a CTA "
                        "may have), level 2 in "
                        "64-query steps; one CTA a 64-key tile walks the "
                        "whole GQA group",
}
# The full-integer backward's precondition (the JAX package's): SYMMETRIC
# CHANNEL or TENSOR V; the joint latent's V is quantized CHANNEL for it.
WIDE_PATH_CALLS = ("exact", "quantize_q", "fullint", "facade")


def check_quantized_width(rng, d, shape, errs, fullint=True, block2d=True):
    """Every quantized kernel at head dim ``d`` against its plain version
    at ``shape`` (B, Hq, Hkv, S, S), two calls bit for bit: the forward in
    int8 / int4 dequant, folded ROW / CHANNEL / TENSOR, BLOCK_2D, an int8
    Q with int8 P over block_kv spans of 128 and 256, an int8 Q over ROW
    V, bias, a sliding window, an fp32 Q and an fp32 Q quantized to int8;
    the exact dQ and dK/dV in those modes with dbias; with ``fullint`` the
    full-integer pair at levels 1 and 2; ``block2d`` False leaves out the
    BLOCK_2D modes (16-lane blocks, which a head dim off the multiples of
    16 does not hold).  Into ``errs``, {label: errors} (a check whose two
    calls differ raises)."""
    row8, row8c, row4c = qcfg(), qcfg(strategy="centered"), qcfg(
        bits=4, strategy="centered")
    ten8, ch8, ch4 = qcfg(gran="tensor"), qcfg(gran="channel"), qcfg(
        bits=4, gran="channel")
    b2d = qcfg(gran="block_2d", strategy="centered", block_rows=4,
               block_size=16)
    window = masking.sliding_window(96, causal=True)
    bias = (1,) + shape[1:2] + shape[3:]
    for label, kcfg, vcfg, opts in (
            ("int8 ROW CENTERED", row8c, row8c, {}),
            ("int4 ROW CENTERED", row4c, row4c, {}),
            ("folded ROW", row8, row8, {}),
            ("folded CHANNEL int4 K", ch4, ch8, {}),
            ("folded TENSOR", ten8, ten8, {}),
            *((("BLOCK_2D 16", b2d, b2d, {}),) if block2d else ()),
            ("int8 Q / int8 P, 128-key spans", row8, ch8,
             dict(quantize_q=True, block_kv=128)),
            ("int8 Q / int8 P, 256-key spans", row8, ch8,
             dict(quantize_q=True, block_kv=256)),
            ("int8 Q, ROW V", row8, row8, dict(quantize_q=True)),
            ("bias", row8c, row8c, dict(bias_shape=bias)),
            ("window-causal", row8c, row4c, dict(mask=window)),
            ("fp32 Q", row8c, row4c, dict(dtype=torch.float32)),
            ("fp32 Q to int8", row8, row4c,
             dict(dtype=torch.float32, quantize_q=True))):
        errs[f"fwd d{d} {label}"] = check_qattn(
            rng, f"D={d} {label}", *shape, d, kcfg, vcfg, repeat=True,
            **opts)
    for label, kcfg, vcfg, opts in (
            ("int8 ROW CENTERED", row8c, row8c, {}),
            ("int4 ROW CENTERED", row4c, row4c, {}),
            ("folded ROW", row8, row8, {}),
            ("folded CHANNEL int4", ch4, ch4, {}),
            ("folded TENSOR", ten8, ten8, {}),
            *((("BLOCK_2D 16", b2d, b2d, {}),) if block2d else ()),
            ("bias-dbias", row8c, row8c, dict(bias_shape=bias)),
            ("window-causal", row8c, row4c, dict(mask=window)),
            ("fp32", row8c, row4c, dict(dtype=torch.float32))):
        errs[f"qflash d{d} {label}"] = check_qflash(
            rng, f"D={d} {label}", *shape, d, kcfg, vcfg, repeat=True,
            **opts)
    if not fullint:
        return
    spans = BlockSizes(block_kv_dq=128, block_q_dkv=128)
    for label, kcfg, vcfg in (("ROW K / CHANNEL V", row8, ch8),
                              ("TENSOR K / TENSOR V", ten8, ten8)):
        for level2 in (False, True):
            errs[f"fullint d{d} {label} l{2 if level2 else 1}"] = (
                check_fullint(rng, f"D={d} {label}", 1, 8, 1, 512, d,
                              kcfg, vcfg, level2, spans, repeat=True))


def check_wide_kernels_all(rng):
    """(a) Every wide kernel against its plain version at D = 288 and 272
    (Hq=8 over Hkv=1, S=300, as MLA's group), two calls bit for bit
    (check_quantized_width), and the level-2 full-integer pair at spans
    below one k step.  → {label: errors}."""
    errs = {}
    for d in (MLA_QD, 272):
        check_quantized_width(rng, d, (2, 8, 1, 300, 300), errs)
    # Level-2 spans below one k step (S=144: 16 wide): the __dp4a pair.
    errs[f"fullint d{MLA_QD} w16 l2"] = check_fullint(
        rng, f"D={MLA_QD} ROW K / CHANNEL V, S=144", 1, 8, 1, 144, MLA_QD,
        qcfg(), qcfg(gran="channel"), True,
        BlockSizes(block_kv_dq=512, block_q_dkv=512), repeat=True)
    log(f"phase 19 (a): {len(errs)} checks, each bit for bit on a repeat")
    return errs


def mla_joint_operands(seed, cfg=None, gen=None, absorbed=False):
    """``cfg``'s layer 0 (MLAConfig()'s by default; bf16 weights from the
    seed, as phase 15 draws them, on ``gen`` where given) on one seeded
    batch of B=2 x S=2048 tokens: the absorbed query [q·W_uk | q_rope]
    [2, 16, 2048, d_c + d_r] bf16, the joint latent [C | K_rope] and
    [C | 0], fp32 [2, 1, 2048, d_c + d_r]; with ``absorbed`` also the
    operands of ``mla_absorbed_attention`` over the bare latent: q (NoPE)
    [2, 16, 2048, d_h], C [2, 2048, d_c] fp32, W_uk, W_uv."""
    cfg = cfg or MLAConfig()
    params = init_mla_params(cfg, gen or torch.Generator().manual_seed(seed),
                             device=DEV)
    layer = params["layers"][0]
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (DEC_B, DEC_S))).to(DEV)
    pos = torch.arange(DEC_S, device=DEV)
    hn = rms_norm(F.embedding(tokens, params["embed"]), layer["ln1"])
    q, q_rope = mla_layer_q(layer, hn, pos, cfg)
    c_kv, k_rope = mla_layer_kv(layer, hn, pos, cfg)
    q_lat = torch.cat([torch.einsum("bhsd,hdc->bhsc", q.float(),
                                    layer["w_uk"].float()).to(q.dtype),
                       q_rope.to(q.dtype)], dim=-1).contiguous()
    c, kr = c_kv.float()[:, None], k_rope.float()[:, None]
    k = torch.cat([c, kr], dim=-1).contiguous()
    v = torch.cat([c, torch.zeros_like(kr)], dim=-1).contiguous()
    bare = (q, c_kv.float(), layer["w_uk"], layer["w_uv"])
    del params
    return (q_lat, k, v) + ((bare,) if absorbed else ())


def wide_path_call(kind, k, v, kq, vq, vq_ch, scale=MLA_SCALE):
    """(the call as a function of (q, K scale, V scale), its mask, its K/V
    as the kernels see them, whether it quantizes Q, whether its backward
    is full-integer).  The scales go into the K/V by
    ``dataclasses.replace``, so autograd returns K's and V's gradients
    (their scales' cotangents) beside dq."""
    if kind == "facade":
        attn = QuantizedAttention(
            QuantizedAttentionConfig(key_bits=8, value_bits=8),
            mask=masking.CAUSAL, scale=scale)
        kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)

        def facade(q, ks, vs):  # the facade's __call__, scales as leaves
            fkq, fvq = attn.quantize_kv(kb, vb)
            return attn.forward_quantized(
                q, dataclasses.replace(fkq, scale=ks),
                dataclasses.replace(fvq, scale=vs))

        return (facade, masking.CAUSAL, attn.quantize_kv(kb, vb), False,
                False)
    fullint, quantize_q = kind == "fullint", kind == "quantize_q"
    cvq = vq_ch if fullint else vq
    mask = masking.FULL if fullint else masking.CAUSAL
    return (quantized_call(kq, cvq, mask, quantize_q, fullint, scale), mask,
            (kq, cvq), quantize_q, fullint)


def quantized_call(kq, vq, mask, quantize_q, fullint, scale=MLA_SCALE):
    """``quantized_flash_attention`` over (kq, vq) as a function of (q, K
    scale, V scale)."""
    def call(q, ks, vs):
        return tqa.quantized_flash_attention(
            q, dataclasses.replace(kq, scale=ks),
            dataclasses.replace(vq, scale=vs), mask=mask, scale=scale,
            quantize_q=quantize_q, bwd_fullint=fullint)

    return call


def wide_call_grads(fn, q, kq, vq, do):
    """O and autograd's (dq, dK scale, dV scale) of one call ``fn``."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (q, kq.scale, vq.scale)]
    with torch.enable_grad():
        o = fn(*leaves)
        grads = torch.autograd.grad((o.float() * do.float()).sum(), leaves)
    return o.detach(), grads


def wide_kv_grads(q, kq, vq, do, mask, quantize_q, fullint,
                  scale=MLA_SCALE):
    """dK, dV (with respect to the dequantized K/V) of
    ``flash_attention_backward``, the backward the path's autograd
    Function runs, on the residuals of the call's forward."""
    o, lse = quantized_flash_attention_forward(
        q, kq, vq, mask=mask, scale=scale, quantize_q=quantize_q)
    return fbwd.flash_attention_backward(q, kq, vq, o, lse, do, mask=mask,
                                         scale=scale, fullint=fullint)[1:3]


def wide_call_kernels(label, q, kq, vq, do, mask, quantize_q, fullint,
                      o_path, scale=MLA_SCALE):
    """The call's O against the plain forward on its own inputs, and the
    kernels the call launched, rebuilt on those inputs and held to their
    plain versions → ({name: errors}, the kernels' arguments)."""
    s = q.shape[2]
    f_args, f_kw = qattn_arguments(q, kq, vq, mask=mask, scale=scale,
                                   quantize_q=quantize_q)
    f_kw["kv_tile"] = main_path_tile(f_kw, s)
    o, lse = qattn_fwd(*f_args, **f_kw)
    torch.cuda.synchronize()
    body = qattn_body(f_args[0].dtype, f_kw["mode"], d=q.shape[-1])
    o_plain, lse_plain = qattn_fwd_plain(
        *f_args, **{**f_kw, "kv_tile": f_kw["kv_tile"] or KV_TILE})
    errs = {"qattn_fwd": check_pair(f"{label}: qattn_fwd ({body})", (o, lse),
                                    (o_plain, lse_plain))}
    errs["call_o"] = (rel_err(o_path, o_plain), max_abs(o_path, o_plain))
    log(f"{label}: the call's O vs the plain forward {errs['call_o'][0]:.2e}"
        f" (max abs {errs['call_o'][1]:.2e})")
    if not errs["call_o"][0] <= FLASH_TOL[torch.bfloat16]:
        raise AssertionError(f"{label}: the call's O disagrees with the "
                             f"plain forward: {errs['call_o']}")
    del o_plain, lse_plain
    di = (do.float() * o).sum(-1)
    if fullint:
        (a1, k1), (a2, k2) = fbwd.fullint_arguments(
            q, kq, vq, None, lse, do, scale=scale, di=di)
        names = ("fullint_dq", "fullint_dkv")
    else:
        rr = row_ranges_tensor(mask, s, s, None, DEV)
        (a1, k1), (a2, k2) = fbwd.qflash_arguments(
            q, kq, vq, do.to(q.dtype), lse, di, rr, scale=scale)
        names = ("qflash_dq", "qflash_dkv")
    args = {"qattn_fwd": (f_args, f_kw), names[0]: (a1, k1),
            names[1]: (a2, k2)}
    for name, outs in zip(names, (("dq",) if fullint else ("dq", "dbias"),
                                  ("dk", "dv"))):
        a, kw = args[name]
        got = getattr(fbwd, name)(*a, **kw)
        torch.cuda.synchronize()
        want = getattr(fbwd, f"{name}_plain")(*a, **kw)
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        errs[name] = check_bwd_pair(f"{label}: {name}", got, want, outs)
        del got, want
    return errs, args


WIDE_COUNTED = (qattn_fwd, fbwd.qflash_dq, fbwd.qflash_dkv, fbwd.fullint_dq,
                fbwd.fullint_dkv, fbwd.merge_dkv_splits, rtq.rtq_rows)


def check_joint_calls(label, kinds, q_lat, k, v, kq, vq, vq_ch, do, out,
                      splits, scale=MLA_SCALE):
    """Each call of ``kinds`` (wide_path_call's) over the joint latent,
    forward and backward, the counts set to 0 just before and read after
    (one forward, one dQ, one dK/dV and its merge, or the full-integer
    pair; the facade's two row quantizers); dq and K's and V's scale
    cotangents from autograd, and dK, dV from the backward on the call's
    residuals, against the dense fp32 VJP on the dequantized K/V (the
    full-integer ones against the exact call on the same operands); the
    call's O and each launched kernel against its plain version on the
    call's inputs.  ``splits``: the split counts the exact and the
    full-integer dK/dV must take at this shape on an H100's 132 SMs,
    stated by the caller; the planners (``dkv_splits``,
    ``fullint_dkv_splits``) are held to them, and the merge is counted
    where the count is above 1.  Into ``out``."""
    names = ("dq", "dk_scale", "dv_scale", "dk", "dv")
    for kind in kinds:
        fn, mask, (ckq, cvq), quantize_q, fullint = wide_path_call(
            kind, k, v, kq, vq, vq_ch, scale)
        for f in WIDE_COUNTED:
            f.launches = 0
        t0 = time.perf_counter()
        o, grads = wide_call_grads(fn, q_lat, ckq, cvq, do)
        torch.cuda.synchronize()
        out["seconds"][kind] = time.perf_counter() - t0
        counts = {f.__name__: f.launches for f in WIDE_COUNTED if f.launches}
        out["launches"][kind] = counts
        b, hq, s, d = q_lat.shape
        hkv = ckq.shape[1]
        planned = (fbwd.fullint_dkv_splits(d, b, hq, hkv, s, sm_count())
                   if fullint else fbwd.dkv_splits(q_lat.dtype, d, b, hq,
                                                   hkv, s, sm_count()))
        want_splits = splits[1 if fullint else 0]
        if planned != want_splits:
            raise AssertionError(f"{label} {kind}: the dK/dV plan takes "
                                 f"{planned} splits, expected {want_splits}")
        want_counts = {"qattn_fwd": 1,
                       **({"fullint_dq": 1, "fullint_dkv": 1} if fullint else
                          {"qflash_dq": 1, "qflash_dkv": 1}),
                       **({"merge_dkv_splits": 1} if want_splits > 1
                          else {}),
                       **({"rtq_rows": 2} if kind == "facade" else {})}
        log(f"{label}, {kind}: launches {json.dumps(counts)}, "
            f"{out['seconds'][kind]:.3f} s (first call)")
        if counts != want_counts or not (torch.isfinite(o.float()).all()
                                         and o.shape == q_lat.shape):
            raise AssertionError(f"{label} {kind}: launches {counts}, "
                                 f"expected {want_counts}")
        with torch.no_grad():
            got = (*grads, *wide_kv_grads(q_lat, ckq, cvq, do, mask,
                                          quantize_q, fullint, scale))
            if fullint:  # the exact call on the same operands
                exact = quantized_call(ckq, cvq, mask, False, False, scale)
                want = (*wide_call_grads(exact, q_lat, ckq, cvq, do)[1],
                        *wide_kv_grads(q_lat, ckq, cvq, do, mask, False,
                                       False, scale))
            else:
                dq, dk, dv = reference_attention_vjp(
                    q_lat, dequantize(ckq), dequantize(cvq), do, mask=mask,
                    scale=scale)
                want = (dq, tqa._scale_zp_cotangents(dk, ckq)[0],
                        tqa._scale_zp_cotangents(dv, cvq)[0], dk, dv)
            out["grads_rel_l2"][kind] = gate_grads(
                f"{label}, {kind}: dq, K's and V's scale cotangents "
                "(autograd) and dK, dV (the backward on the call's "
                "residuals) vs "
                + ("the exact call on the same operands" if fullint else
                   "the fp32 dense VJP on the dequantized K/V"),
                got, want, names)
            del got, want
            errs, _ = wide_call_kernels(f"{label}, {kind}", q_lat.detach(),
                                        ckq, cvq, do, mask, quantize_q,
                                        fullint, o, scale)
        out["kernels"][kind] = errs
        del o, grads


def run_wide_path(seed):
    """(b) The four calls over MLAConfig()'s joint latent, forward and
    backward, the counts set to 0 just before each and read after; dq and
    K's and V's scale cotangents from autograd, and dK, dV from the
    backward on the call's residuals, against the dense fp32 VJP on the
    dequantized K/V (the full-integer ones against the exact call on the
    same operands); the call's O and each launched kernel against its
    plain version on the call's inputs; the kernels' device names under
    the profiler.  → record."""
    q_lat, k, v = mla_joint_operands(seed)
    g = torch.Generator(device=DEV).manual_seed(seed + 18)
    do = torch.randn(q_lat.shape, generator=g, device=DEV).to(q_lat.dtype)
    row = QuantConfig(granularity=QuantGranularity.ROW)
    kq, vq = quantize(k, row), quantize(v, row)
    vq_ch = quantize(v, QuantConfig(granularity=QuantGranularity.CHANNEL))
    out = {"launches": {}, "grads_rel_l2": {}, "kernels": {}, "seconds": {},
           "shape": "q_lat [2, 16, 2048, 288] bf16, [C | K_rope] int8 ROW "
                    "SYMMETRIC [2, 1, 2048, 288], [C | 0] int8 ROW (CHANNEL "
                    "for the full-integer call), MLAConfig() layer 0, seed "
                    f"{seed}"}
    check_joint_calls("MLA joint latent", WIDE_PATH_CALLS, q_lat, k, v, kq,
                      vq, vq_ch, do, out, splits=(16, 1))
    # The device kernels, by name, of the exact and the full-integer calls;
    # a trace that recorded no kernel (PERF.md §7) is taken again.
    steps = []
    for kind in ("exact", "fullint"):
        fn, _, kv, *_ = wide_path_call(kind, k, v, kq, vq, vq_ch)

        def step(fn=fn, kv=kv):
            wide_call_grads(fn, q_lat, *kv, do)

        steps.append(step)
    for _ in range(3):
        seen = [n for step in steps for n in device_ms_by_kernel(step, 2)]
        # Each family by name, at D = 288 (the merge has no head dim).
        families = {fam: [n for n in seen if fam in n and (
                        "288" in n or fam == "flash_dkv_merge_kernel")]
                    for fam in ("qattn_fwd_wide_kernel",
                                "qflash_dq_wide_kernel",
                                "qflash_dkv_wide_kernel",
                                "flash_dkv_merge_kernel",
                                "fullint_dq_tc_kernel",
                                "fullint_dkv_tc_kernel")}
        if all(families.values()):
            break
    log("MLA joint latent, device kernels by the profiler: "
        + json.dumps({f: [kernel_label(n) + (" <288>" if "288" in n else "")
                          for n in ns] for f, ns in families.items()}))
    if not all(families.values()):
        raise AssertionError(f"wide path: kernels missing from the trace: "
                             f"{families}; traced: "
                             f"{sorted({kernel_label(n) for n in seen})}")
    out["device_kernels"] = {f: ns[0][:160] for f, ns in families.items()}
    return out, (q_lat, kq, vq, vq_ch, do)


def run_wide_long_context(rng, width=MLA_QD, dc=LONG_SHAPE[4],
                          scale=MLA_SCALE):
    """(c) Phase 17's 32K construction over the joint latent of ``width``
    lanes (MLA's 288: d_c = 256; phase 22: DeepSeek's 576, d_c = 512):
    ``quantized_flash_attention_forward`` at B=1, H=8, S=32768 over
    [C | K_rope] and [C | 0] quantized int8 ROW CENTERED, a causal window
    of 4096: one launch, a finite output; then the kernel against its plain
    version at S = LONG_PLAIN_S on the arguments the path builds."""
    b, h, s = LONG_SHAPE[:3]
    dr = width - dc
    g = device_generator(rng)
    q = torch.randn((b, h, s, width), generator=g, device=DEV).to(
        torch.bfloat16)
    c = torch.randn((b, 1, s, dc), generator=g, device=DEV)
    kr = torch.randn((b, 1, s, dr), generator=g, device=DEV)
    k = torch.cat([c, kr], dim=-1)
    v = torch.cat([c, torch.zeros_like(kr)], dim=-1)
    del c, kr
    row8c = QuantConfig(granularity=QuantGranularity.ROW,
                        strategy=QuantStrategy.CENTERED)
    mask = masking.sliding_window(LONG_WINDOW, causal=True)
    kq, vq = quantize(k, row8c), quantize(v, row8c)
    qattn_fwd.launches = 0
    t0 = time.perf_counter()
    o, _ = quantized_flash_attention_forward(q, kq, vq, mask=mask,
                                             scale=scale)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = qattn_fwd.launches
    finite = bool(torch.isfinite(o).all())
    n = LONG_PLAIN_S
    ks, vs = quantize(k[:, :, :n], row8c), quantize(v[:, :, :n], row8c)
    args, kw = qattn_arguments(q[:, :, :n], ks, vs, mask=mask,
                               scale=scale)
    tile = main_path_tile(kw, n)
    got = qattn_fwd(*args, **kw, kv_tile=tile)
    torch.cuda.synchronize()
    errs = check_pair(f"qattn_fwd {kw['mode'].k_scales} K, causal window "
                      f"{LONG_WINDOW}, Hq={h} over Hkv=1, D={width} "
                      f"(joint latent), S={n}", got,
                      qattn_fwd_plain(*args, **kw, kv_tile=tile or KV_TILE))
    log(f"long context at D={width} (B={b} H={h} S={s}, int8 ROW CENTERED "
        f"[C | K_rope], window {LONG_WINDOW}): qattn_fwd launches "
        f"{launches}, output {tuple(o.shape)} finite {finite}, "
        f"{seconds:.3f} s (first call)")
    if launches != 1 or not finite or o.shape != (b, h, s, width):
        raise AssertionError(f"long context D={width}: launches {launches},"
                             f" finite {finite}, shape {tuple(o.shape)}")
    return {"launches": launches, "finite": finite, "seconds": seconds,
            "kernel_vs_plain_s8192": errs}


def sdpa_backward(q, k, v, do, causal, scale):
    """SDPA's backward over (q, k, v) as one call (dq, dk and dv together;
    the backend torch takes: MATH at 576)."""
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(
            qg, kg, vg, is_causal=causal, enable_gqa=True, scale=scale)
    return lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                       retain_graph=True)


def time_wide_kernels(path_inputs, scale=MLA_SCALE, fullint_only=False,
                      fam=None):
    """(d) The new kernels alone at (b)'s shape, each on the arguments its
    call built: events and the profiler's device ms (by kernel), the bound,
    the plain version's ms, and SDPA's forward / backward over the
    dequantized bf16 K/V as the library yardstick.  The forward and the
    exact pair in the exact call's mode (folded ROW K / ROW V, causal), the
    forward also with an int8 Q; at 288 (phase 19) the full-integer pair
    at levels 1 and 2 (FULL, ROW K / CHANNEL V; ``vq_ch`` None at 576,
    where phase 22 leaves it to phase 23) and, with ``--parent``, each
    kernel on the parent's library too, in turns; ``fullint_only``: the
    full-integer pair alone (phase 23 at 576).  Entries "{family}_wide" at
    288, "{family}_latent" at 576 (``fam`` names others),
    "fullint_{dq,dkv}_d{D}"."""
    q, kq, vq, vq_ch, do = path_inputs
    b, h, s, d = q.shape
    fam = fam or ("wide" if d <= 288 else "latent")
    hkv = kq.shape[1]
    full = b * h * s * s
    n_q, n_kv, rows = b * h * s * d, b * hkv * s * d, b * h * s

    def timed(name, kernel, plain, library, bound):
        t = {"plain_ms": time_ms(plain, 1, warmup=1),
             "ms": time_ms(kernel, 5, warmup=1)}
        t["ms_2"] = time_ms(kernel, 5, warmup=0)
        t["library_ms"] = time_ms(library, 3, warmup=1)
        # The profiler at times records no kernel of a call (§7 of
        # PERF.md); a second trace then takes its place, and where that
        # records no launch of the call's own kernel either (the merge
        # aside), the held events' time stands in.
        by = device_ms_by_kernel(kernel, 5) or device_ms_by_kernel(kernel, 5)
        t["library_device_ms"] = sum(device_ms_by_kernel(library, 3).values())
        t["device_ms_by_kernel"] = {kernel_label(k): v for k, v in by.items()}
        t["device_ms"] = (
            sum(by.values())
            if set(t["device_ms_by_kernel"]) - {"flash_dkv_merge_kernel"}
            else measure_held(kernel, iters=5, warmup=0) * 1e3)
        t["bound_ms"], t["bound_by"] = bound
        if fam in ("wide", "split_d"):  # the parent has these kernels
            parent_turns(f"{name} (D={d})", t, kernel, 5, device=True)
        if fam == "split_d" and PARENT["lib"] is not None:
            t["parent_bits_equal"] = parent_bits(kernel)
        log(f"{name} times (D={d}): " + json.dumps(t))
        return t

    times = {}
    stats = 4 * rows
    if not fullint_only:
        times.update(time_wide_exact(q, kq, vq, do, scale, fam, timed))
    if vq_ch is None:
        return times
    o, lse = quantized_flash_attention_forward(q, kq, vq_ch, scale=scale)
    di = (do.float() * o).sum(-1)
    lib = sdpa_backward(q, dequantized_bf16(kq), dequantized_bf16(vq_ch), do,
                        False, scale)
    int8_in = 2 * n_q + 2 * n_kv
    for level2 in (False, True):
        (f_dq, f_dq_kw), (f_dkv, f_dkv_kw) = fbwd.fullint_arguments(
            q, kq, vq_ch, None, lse, do, scale=scale, di=di,
            int8_grads=level2)
        tag = "_level2" if level2 else ""
        ops_dq = (6 * d, 0) if level2 else (4 * d, 2 * d)
        ops_dkv = (8 * d, 0) if level2 else (4 * d, 4 * d)
        for name, fn, plain, a, kw, ops, nbytes in (
                (f"fullint_dq_d{d}", fbwd.fullint_dq, fbwd.fullint_dq_plain,
                 f_dq, f_dq_kw, ops_dq,
                 int8_in + 4 * stats + 4 * b * hkv * s + 4 * n_q),
                (f"fullint_dkv_d{d}", fbwd.fullint_dkv,
                 fbwd.fullint_dkv_plain, f_dkv, f_dkv_kw, ops_dkv,
                 int8_in + n_q + 5 * stats + 4 * b * hkv * s + 8 * n_kv)):
            t = timed(f"{name} level {2 if level2 else 1} (width "
                      f"{kw['width']})", lambda: fn(*a, **kw),
                      lambda: plain(*a, **kw), lib,
                      attn_bound(full, *ops, nbytes))
            t["body"] = fullint_body(d, kw["width"])
            t["width"] = kw["width"]
            if level2:
                times[name].update({f"{k}_level2": v for k, v in t.items()})
            else:
                times[name] = t
        if d > 288:
            times[f"fullint_dkv_d{d}"]["splits"] = fbwd.fullint_dkv_splits(
                d, b, h, hkv, s, sm_count())
    return times


def time_wide_exact(q, kq, vq, do, scale, fam, timed):
    """time_wide_kernels' forward (bf16 and int8 Q) and exact pair, folded
    ROW K / ROW V, causal → {name: times}."""
    b, h, s, d = q.shape
    hkv = kq.shape[1]
    causal = b * h * s * (s + 1) // 2
    n_q, n_kv, rows = b * h * s * d, b * hkv * s * d, b * h * s
    kd, vd = dequantized_bf16(kq), dequantized_bf16(vq)

    times = {}
    for tag, qq in (("", False), ("_int8_q", True)):
        a, kw = qattn_arguments(q, kq, vq, mask=masking.CAUSAL,
                                scale=scale, quantize_q=qq)
        kw["kv_tile"] = main_path_tile(kw, s)
        ops = (2 * d, 2 * d) if qq else (0, 4 * d)
        t = timed(f"qattn_fwd_{fam} folded ROW{tag}",
                  lambda: qattn_fwd(*a, **kw),
                  lambda: qattn_fwd_plain(*a, **{**kw, "kv_tile": kw[
                      "kv_tile"] or KV_TILE}),
                  lambda: F.scaled_dot_product_attention(
                      q, kd, vd, is_causal=True, enable_gqa=True,
                      scale=scale),
                  attn_bound(causal, *ops, (1 if qq else 2) * n_q
                             + 2 * n_kv + 8 * b * hkv * s + 4 * n_q
                             + 4 * rows))
        t["body"] = qattn_body(a[0].dtype, kw["mode"], d=d)
        t["splits"] = tqa.qattn_splits(kw["mode"], kw["kv_tile"] or KV_TILE,
                                       d, b, h, s, s, sm_count())
        times[f"qattn_fwd_{fam}{tag}"] = t
    o, lse = quantized_flash_attention_forward(q, kq, vq, mask=masking.CAUSAL,
                                               scale=scale)
    di = (do.float() * o).sum(-1)
    rr = row_ranges_tensor(masking.CAUSAL, s, s, None, DEV)
    (e_dq, e_dq_kw), (e_dkv, e_dkv_kw) = fbwd.qflash_arguments(
        q, kq, vq, do, lse, di, rr, scale=scale)
    lib = sdpa_backward(q, kd, vd, do, True, scale)
    stats = 4 * rows
    times[f"qflash_dq_{fam}"] = timed(
        f"qflash_dq_{fam} folded ROW",
        lambda: fbwd.qflash_dq(*e_dq, **e_dq_kw),
        lambda: fbwd.qflash_dq_plain(*e_dq, **e_dq_kw), lib,
        attn_bound(causal, 0, 6 * d, 4 * n_q + 2 * n_kv + 8 * b * hkv * s
                   + 2 * stats + 4 * b * hkv * d + 4 * n_q))
    times[f"qflash_dkv_{fam}"] = timed(
        f"qflash_dkv_{fam} per-token dequant, its merge included",
        lambda: fbwd.qflash_dkv(*e_dkv, **e_dkv_kw),
        lambda: fbwd.qflash_dkv_plain(*e_dkv, **e_dkv_kw), lib,
        attn_bound(causal, 0, 8 * d, 4 * n_q + 2 * n_kv + 16 * b * hkv * s
                   + 2 * stats + 8 * n_kv))
    for name in (f"qflash_dq_{fam}", f"qflash_dkv_{fam}"):
        times[name]["body"] = dq_body(q.dtype, d)
    times[f"qflash_dkv_{fam}"]["splits"] = fbwd.dkv_splits(
        q.dtype, d, b, h, hkv, s, sm_count())
    return times


def run_wide_quantized(seed):
    """Phase 19 (a)-(d), inputs from a thirteenth generator (seed + 12) →
    (record, phase seconds)."""
    rng = np.random.default_rng(seed + 12)
    out, phase = {}, {}
    t = time.perf_counter()
    with torch.inference_mode():
        out["errors"] = check_wide_kernels_all(rng)
    phase["wide_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    out["path"], path_inputs = run_wide_path(seed)
    phase["wide_path"] = time.perf_counter() - t
    t = time.perf_counter()
    with torch.inference_mode():
        out["long_context"] = run_wide_long_context(rng)
    phase["wide_long_context"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    with torch.no_grad():
        out["times"] = time_wide_kernels(path_inputs)
    phase["wide_times"] = time.perf_counter() - t
    return out, phase


# --------------------------------------------------------------------------
# Phase 20: MLA serving at DeepSeek's absorbed width 576
# --------------------------------------------------------------------------

# DeepSeek-V2-Lite at full width, from
# https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json:
# no q_lora_rank, so MLAConfig's fields express its attention exactly: 16
# heads of qk_nope_head_dim = v_head_dim = 128, kv_lora_rank 512 and
# qk_rope_head_dim 64 (the paged kernels' head dim: 512 + 64 = 576),
# hidden 2048, vocab 102400, 27 layers, rope_theta 10000.  Left out: the
# 26 MoE layers are dense SwiGLU at the dense first layer's
# intermediate_size 10944 (MLAConfig has no experts), and YaRN RoPE
# scaling (MLAConfig has none); max_seq 4096, the engine's capacity.
# utils/profiling.py's --mla --v2-lite serves the same configuration
# (DEEPSEEK_V2_LITE, held equal to this one).
V2_LITE = MLAConfig(vocab_size=102400, d_model=2048, num_layers=27,
                    num_heads=16, head_dim=128, latent_dim=512, rope_dim=64,
                    d_ff=10944, rope_theta=10000.0, max_seq=4096)
DS_HQ, DS_D, DS_VTZ = V2_LITE.num_heads, V2_LITE.cache_width, V2_LITE.rope_dim
DS_SCALE = (V2_LITE.head_dim + V2_LITE.rope_dim) ** -0.5
# (label, head dim, page states, v_tail_zero) of (a): DeepSeek's one-state
# latent pages, a run-time width inside the 576 instances, and two-state
# pages at 576 (the prefill's scalar route).
DS_GEOMS = (("d576", DS_D, 1, DS_VTZ), ("d320", 320, 1, DS_VTZ),
            ("d576_two_state", DS_D, 2, DS_VTZ))
# V2-Lite's projections through the dynamic GEMM, (N, K): wq and wo, wqr,
# wdkv, wkr, wg and wu, wd, the unembedding.
V2_LITE_GEMMS = {"wq": (2048, 2048), "wqr": (1024, 2048),
                 "wdkv": (512, 2048), "wkr": (64, 2048), "wo": (2048, 2048),
                 "wg": (10944, 2048), "wd": (2048, 10944),
                 "unembed": (102400, 2048)}


def check_deepseek_paged(rng):
    """(a) Both paged kernels at DeepSeek's geometry (Hq=16 over the one
    latent head, scale (128 + 64)^-0.5) for each of DS_GEOMS, with bf16
    and int8 pools (bf16 q, max abs ≤ KERNEL_TOL) and an fp32 pool and q
    (≤ TOLERANCES["fp32"]): the decode at phase 2's lengths over the
    engine's capacity (16 pages of 256), the prefill's 256-row chunk at
    offsets 0, 300 and 512; each called twice, equal bit for bit, V's zeroed
    tail zero in the output.  → ({label: max abs err}, {label: body})."""
    gen = device_generator(rng)
    pt, num_pages, max_pages, chunk = 256, 256, 16, 256
    lengths = np.asarray([1, pt, pt + 1, 1800, 3 * pt + 17, 37, 1024, 4000],
                         np.int32)
    ln = torch.from_numpy(lengths).to(DEV)
    errs, bodies = {}, {}
    for geom, d, states, vtz in DS_GEOMS:
        for kind in ("bf16", "int8", "f32"):
            dtype = torch.float32 if kind == "f32" else torch.bfloat16
            pool, kw = paged_pool_f32(gen, "int8" if kind == "int8" else "f32",
                                      1, num_pages, pt, d, states)
            if kind == "bf16":
                pool = pool.to(torch.bfloat16)
            kw.update(page_tokens=pt, v_tail_zero=vtz, scale=DS_SCALE)
            table = page_tables(rng, lengths, pt, num_pages, max_pages)
            q = torch.randn((len(lengths), DS_HQ, d), generator=gen,
                            device=DEV).to(dtype)
            calls = [("decode", paged_decode_attention,
                      paged_decode_attention_plain, (q, pool, table, ln))]
            for offset in (0, 300, 512):
                row = page_tables(rng, [offset + chunk], pt, num_pages,
                                  max_pages)[0]
                qp = torch.randn((DS_HQ, chunk, d), generator=gen,
                                 device=DEV).to(dtype)
                calls.append((f"prefill_{offset}", paged_prefill_attention,
                              paged_prefill_attention_plain,
                              (qp, pool, row, offset)))
            tol = TOLERANCES["fp32"] if kind == "f32" else KERNEL_TOL
            for name, fn, plain, args in calls:
                label = f"{name} {geom} {kind}"
                first = fn(*args, **kw)
                second = fn(*args, **kw)
                torch.cuda.synchronize()
                errs[label] = max_abs(first, plain(*args, **kw))
                tail = first[..., d - vtz:].float().abs().max().item()
                same = torch.equal(first, second)
                if not (errs[label] <= tol and tail == 0.0 and same):
                    raise AssertionError(
                        f"paged {label}: max abs {errs[label]} (tol {tol}), "
                        f"rope-tail max {tail}, two calls equal: {same}")
            bodies[f"{geom} {kind}"] = {
                "decode": decode_body(dtype, d),
                "prefill": prefill_body(dtype, d, states, vtz)}
    log(f"paged kernels at DeepSeek's geometry, {len(errs)} checks, each "
        "called twice and equal bit for bit, max abs err (tol "
        f"{KERNEL_TOL} bf16 / int8 pools, {TOLERANCES['fp32']} fp32): "
        + json.dumps(errs))
    log("their bodies: " + json.dumps(bodies))
    return errs, bodies


def check_deepseek_dyn_gemm(rng):
    """(a) The dynamic GEMM at V2-Lite's projection shapes, M = 1 (the
    prefill's last row), 8 (a decode batch) and 256 (a prefill chunk),
    int8 ROW weights (quantize_mla_weights' WEIGHT_CFG), bit for bit with
    its plain version.  → the number of shapes checked."""
    cases = [(m, n, k) for m in (1, 8, 256)
             for n, k in sorted(set(V2_LITE_GEMMS.values()))]
    for m, n, k in cases:
        args, kw = gemm_operands(rng, m, n, k, WEIGHT_CFG)
        out = dyn_gemm(*args, **kw)
        torch.cuda.synchronize()
        ref = dyn_gemm_plain(*args, **kw)
        if not torch.equal(out, ref):
            raise AssertionError(f"dyn_gemm M={m} N={n} K={k} differs from "
                                 f"its plain version: max abs "
                                 f"{max_abs(out, ref)}")
    log(f"dyn_gemm at V2-Lite's shapes: {len(cases)} cases bit-identical to "
        "the plain version")
    return len(cases)


@contextlib.contextmanager
def plain_calls_on_card():
    """Counts, while open, the calls of the paged kernels', the dynamic
    GEMM's and the flash forward's, dQ's, dK/dV's and merge's plain
    versions that get a CUDA tensor: the wrappers reach them through their
    modules' globals, so patching those sees every call."""
    from metal_flash_attention_plus_tpu_torch.ops import quantized_gemm
    from metal_flash_attention_plus_tpu_torch.serving import paged_attention

    # The module, which the package's flash_attention function shadows.
    flash_module = importlib.import_module(
        "metal_flash_attention_plus_tpu_torch.ops.flash_attention")
    counts = {}
    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (paged_attention, "paged_decode_attention_plain"),
        (paged_attention, "paged_prefill_attention_plain"),
        (quantized_gemm, "dyn_gemm_plain"),
        (flash_module, "flash_attention_forward_plain"),
        (fbwd, "flash_attention_dq_plain"),
        (fbwd, "flash_attention_dkv_plain"),
        (fbwd, "merge_dkv_splits_plain"))]
    for mod, name, fn in saved:
        def counted(*args, _fn=fn, _name=name, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                counts[_name] = counts.get(_name, 0) + 1
            return _fn(*args, **kw)
        setattr(mod, name, counted)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def engine_device_time(cfg, params, seed, quantized_cache, every=5):
    """The 8 requests served once more, every ``every``-th engine step
    under the profiler (the whole run's ~10^5 kernels would take the
    profiler minutes to read): the sampled steps' device busy ms, its idle
    share of their wall time (each step ends in a fence or a read-back)
    and the device ms by kernel (``kernel_label``), the 12 largest."""
    engine = ServingEngine(params, cfg, quantized_cache=quantized_cache,
                           executor=mla_executor(), device=DEV)
    for req in smoke_requests(cfg, seed):
        engine.submit(req)
    torch.cuda.synchronize()
    by, walls = {}, []

    def collect(prof):
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and e.self_device_time_total):
                key = kernel_label(e.key)
                by[key] = by.get(key, 0.0) + e.self_device_time_total / 1e3

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=every - 1, warmup=0,
                                             active=1),
            on_trace_ready=collect) as prof:
        step, more = 0, True
        while more:
            t0 = time.perf_counter()
            more = engine.step()
            torch.cuda.synchronize()
            if step % every == every - 1:
                walls.append(time.perf_counter() - t0)
            prof.step()
            step += 1
    busy = sum(by.values())
    return {"steps": step, "sampled_steps": len(walls),
            "sampled_wall_s": sum(walls), "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / 1e3 / sum(walls),
            "device_ms_by_kernel": dict(sorted(
                by.items(), key=lambda kv: -kv[1])[:12])}


def run_deepseek(seed, dec_lens):
    """Phase 20 (a)-(d), inputs from a fourteenth generator (seed + 13),
    V2_LITE's weights from ``seed`` on the card → (record, phase
    seconds)."""
    if V2_LITE != DEEPSEEK_V2_LITE:
        raise AssertionError("utils/profiling.py's DEEPSEEK_V2_LITE differs "
                             "from V2_LITE")
    rng = np.random.default_rng(seed + 13)
    out, phase = {}, {}
    t = time.perf_counter()
    with torch.inference_mode():
        out["paged_errors"], out["paged_bodies"] = check_deepseek_paged(rng)
        out["dyn_gemm_cases"] = check_deepseek_dyn_gemm(rng)
    phase["deepseek_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    cfg = V2_LITE
    params = init_mla_params(cfg, torch.Generator(device=DEV).manual_seed(
        seed), device=DEV)
    qparams = quantize_mla_weights(params)
    phase["deepseek_init"] = time.perf_counter() - t
    t = time.perf_counter()
    out["logits_rel_l2"] = {}
    mla = dict(executor=mla_executor(), oracle=MLA_ORACLE)
    with torch.inference_mode():
        out["logits_rel_l2"]["float"] = check_logits(
            cfg, params, rng, label="V2-Lite float latent", **mla)
        out["logits_rel_l2"]["w8a8+int8"] = check_logits(
            cfg, qparams, rng, params32=dequantized_fp32(qparams),
            quantized=8, tol=QUANT_LOGITS_TOL[8],
            label="V2-Lite w8a8+int8 latent", **mla)
    torch.cuda.empty_cache()
    phase["deepseek_logits"] = time.perf_counter() - t
    t = time.perf_counter()
    out["engines"] = {}
    for label, p, pool in (("float", params, False),
                           ("w8a8+int8", qparams, 8)):
        with plain_calls_on_card() as plain:
            launches, stats, _, rates = run_engine(
                cfg, p, seed, quantized_cache=pool,
                label=f"V2-Lite engine {label}", executor=mla_executor(),
                layer_gemms=8)
        if plain:
            raise AssertionError(f"V2-Lite engine {label}: plain versions "
                                 f"ran on the card: {plain}")
        device = engine_device_time(cfg, p, seed, pool)
        log(f"V2-Lite engine {label} device time: " + json.dumps(device))
        out["engines"][label] = {"launches": launches, "rates": rates,
                                 "model_calls": stats["prefill_calls"]
                                 + stats["decode_calls"],
                                 "plain_calls_on_card": 0,
                                 "device_time": device}
    del params, qparams
    torch.cuda.empty_cache()
    phase["deepseek_engines"] = time.perf_counter() - t
    t = time.perf_counter()
    with torch.inference_mode():
        out["paged_times"] = time_mla_paged(
            rng, dec_lens, hq=DS_HQ, d=DS_D, vtz=DS_VTZ, scale=DS_SCALE,
            label="DeepSeek D=576", turns=False)
    phase["deepseek_times"] = time.perf_counter() - t
    return out, phase



# --------------------------------------------------------------------------
# Phase 21: MLA training at DeepSeek's absorbed width 576
# --------------------------------------------------------------------------

# V2_LITE's train step on phase 15's batch, 2 x 2049 seeded tokens, Adam at
# lr 3e-3: each of its 27 layers runs the flash forward, dQ and dK/dV at
# D = 512 + 64 = 576, 16 query heads over the one latent head.
DS_TRAIN_BATCH, DS_TRAIN_SEQ, DS_TRAIN_STEPS = 2, 2048, 8
# The bf16 flash kernels at 576 and what the record says of them.
LATENT_KERNELS = {"flash_fwd": "flash_fwd_latent_kernel",
                  "flash_dq": "flash_dq_latent_kernel",
                  "flash_dkv": "flash_dkv_latent_kernel"}
LATENT_REDESIGNED = {
    "flash_fwd": "bf16 mma.sync at D = 576: 8 warps, O's lanes split over "
                 "two warp groups (16 rows x 288 lanes a warp), the two "
                 "warps of a row slab splitting each 32-key tile's scores "
                 "and trading row maxima and sums through shared memory "
                 "under a named barrier; Q resident, 32-key K / V tiles "
                 "double-buffered by cp.async, 230,400 bytes of shared "
                 "memory, one CTA an SM",
    "flash_dq": "bf16 mma.sync at D = 576: Q and dO resident, 32-key K / V "
                "tiles single-buffered with their loads staggered (V's "
                "during S and dQ, K's during dP), 8 warps (16 keys for S "
                "and dP, 288 lanes of dQ a warp), 229,376 bytes of shared "
                "memory",
    "flash_dkv": "bf16 mma.sync at D = 576: 32-key CTAs with K and V "
                 "resident, 32-row Q / dO steps double-buffered by "
                 "cp.async, 8 warps (S^T on four and dP^T on four, dP^T "
                 "handed over through a swizzled fp32 exchange; 16 keys x "
                 "144 lanes of dK and dV a warp), the GQA group dealt over "
                 "dkv_splits CTAs a key tile and summed in split order by "
                 "flash_dkv_merge_kernel",
}


def latent_cases():
    """(label, B, Hq, Hkv, Sq, Skv, D, options) of (a)."""
    seg = masking.build_segment_ranges(np.repeat(np.arange(6), 50))
    seg[77] = (10, 10)  # a row with no live key
    return [
        ("mla_causal_s300", 1, DS_HQ, 1, 300, 300, DS_D, {}),
        ("gqa_interleaved_4_2", 1, 4, 2, 300, 300, DS_D,
         dict(interleaved=True)),
        ("mla_window", 1, DS_HQ, 1, 300, 300, DS_D,
         dict(mask=masking.sliding_window(100, causal=True))),
        ("mla_bias_dbias", 1, DS_HQ, 1, 100, 131, DS_D,
         dict(bias_shape=(1, DS_HQ, 100, 131))),
        ("mla_sq_lt_skv", 1, DS_HQ, 1, 150, 300, DS_D, {}),
        ("gqa_sq_gt_skv_empty_rows", 1, 4, 2, 300, 150, DS_D,
         dict(interleaved=True)),
        ("segments_empty_row", 1, 4, 2, 300, 300, DS_D, dict(
            mask=masking.MaskSpec(masking.MaskKind.SPARSE_RANGES),
            ranges=seg)),
        ("mla_d320", 1, DS_HQ, 1, 300, 300, 320, {}),
        ("v2_lite_b2_s2048", DS_TRAIN_BATCH, DS_HQ, 1, DS_TRAIN_SEQ,
         DS_TRAIN_SEQ, DS_D, {}),
    ]


def check_latent(rng, label, b, hq, hkv, sq, skv, d, dtype,
                 mask=masking.CAUSAL, ranges=None, bias_shape=None,
                 interleaved=False, scale=DS_SCALE):
    """(a) The flash forward (running max, and the static max with a
    caller's bound where there is no bias), dQ with dbias and dK/dV (and
    its merge where ``dkv_splits`` splits) at ``scale`` (V2-Lite's by
    default), each called twice: the two calls equal bit for bit, the
    first held to the plain version → {output: (rel err, max abs err)};
    raises past a gate."""
    q, k, v, do, bias = flash_inputs(rng, b, hq, hkv, sq, skv, d, dtype,
                                     bias_shape)
    rr = row_ranges_tensor(mask, sq, skv, ranges, DEV)
    kw = dict(bias=bias, scale=scale, interleaved_kv=interleaved)
    want_dbias = bias is not None
    fwd = [flash_fwd(q, k, v, rr, **kw) for _ in range(2)]
    o_ref, l_ref = flash_attention_forward_plain(q, k, v, rr, **kw)
    pairs = {"o": (fwd[0][0], o_ref), "l": (fwd[0][1], l_ref)}
    same_bits(f"flash_fwd {label}", fwd[0], fwd[1])
    if bias is None:
        mx = static_row_max(q, k, mask, rr, "caller", scale, interleaved)
        rm = [flash_fwd(q, k, v, rr, **kw, row_max=mx) for _ in range(2)]
        o_sm, l_sm = flash_attention_forward_plain(q, k, v, rr, **kw,
                                                   row_max=mx)
        pairs.update(o_row_max=(rm[0][0], o_sm), l_row_max=(rm[0][1], l_sm))
        same_bits(f"flash_fwd row_max {label}", rm[0], rm[1])
    di = (do.float() * o_ref).sum(-1)
    args = (q, k, v, do, l_ref, di, rr)
    merges = fbwd.merge_dkv_splits.launches
    dq = [flash_dq(*args, want_dbias=want_dbias, **kw) for _ in range(2)]
    dkv = [flash_dkv(*args, **kw) for _ in range(2)]
    merges = fbwd.merge_dkv_splits.launches - merges
    torch.cuda.synchronize()
    same_bits(f"flash_dq {label}", dq[0], dq[1])
    same_bits(f"flash_dkv {label}", dkv[0], dkv[1])
    splits = fbwd.dkv_splits(dtype, d, b, hq, hkv, skv, sm_count())
    if merges != (2 if splits > 1 else 0):
        raise AssertionError(f"flash_dkv {label}: {merges} merges for two "
                             f"calls at {splits} splits")
    dq_ref, dbias_ref = flash_attention_dq_plain(
        *args, want_dbias=want_dbias, **kw)
    dk_ref, dv_ref = flash_attention_dkv_plain(*args, **kw)
    pairs.update(dq=(dq[0][0], dq_ref), dk=(dkv[0][0], dk_ref),
                 dv=(dkv[0][1], dv_ref))
    if want_dbias:
        pairs["dbias"] = (dq[0][1], dbias_ref)
    errs = {}
    for name, (got, want) in pairs.items():
        finite = torch.isfinite(want)
        abs_err = (got.float()[finite] - want.float()[finite]).abs().max()
        errs[name] = (rel_err(got, want), abs_err.item())
    log(f"latent flash {label} D={d} {str(dtype)[6:]} ({splits} splits), "
        "two calls equal bit for bit: " + " ".join(
            f"{n} {e[0]:.2e}" for n, e in errs.items()))
    bad = {n: e[0] for n, e in errs.items() if not e[0] <= (
        LSE_TOL if n.startswith("l") else FLASH_TOL)[dtype]}
    if bad:
        raise AssertionError(f"latent flash {label} {dtype} disagrees: {bad}")
    return errs


def check_latent_all(rng):
    """(a) Every case of ``latent_cases`` in bf16 (the latent kernels) and
    fp32 (the scalar kernels' 32-row tiles) → {"label dtype": errs}."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, hq, hkv, sq, skv, d, kw in latent_cases():
            errs[f"{label} {str(dtype)[6:]}"] = check_latent(
                rng, label, b, hq, hkv, sq, skv, d, dtype, **kw)
    return errs


def check_ds_train_grads(rng, seed):
    """(b) fp32 V2_LITE weights drawn on the card (seed + 14) at B=1,
    S=1024: every parameter's gradient of ``mla_loss_fn`` through the flash
    kernels (fp32 at D = 576: 27 forward, dQ and dK/dV launches, counted)
    against the same call with ``attn_fn=plain_mla_attention`` (no kernel)
    → (worst rel L2, launches); raises past GRAD_REL_L2_TOL."""
    cfg32 = dataclasses.replace(V2_LITE, dtype=torch.float32)
    params32 = init_mla_params(cfg32, torch.Generator(
        device=DEV).manual_seed(seed + 14), device=DEV)
    leaves = trainable_parameters(params32)
    tokens = torch.from_numpy(
        rng.integers(0, cfg32.vocab_size, (1, 1025))).to(DEV)
    zero_flash_counts()
    loss_k = mla_loss_fn(params32, tokens, cfg32)
    loss_k.backward()
    torch.cuda.synchronize()
    launches = flash_counts()
    kernel_grads = [t.grad for t in leaves]
    for t in leaves:
        t.grad = None
    loss_p = mla_loss_fn(params32, tokens, cfg32,
                         attn_fn=plain_mla_attention)
    loss_p.backward()
    worst = max(rel_l2(g, t.grad) for g, t in zip(kernel_grads, leaves))
    log(f"V2-Lite fp32 grads (B=1, S=1024, {len(leaves)} parameters): loss "
        f"kernels {loss_k.item():.6f} plain {loss_p.item():.6f}; worst "
        f"parameter rel L2 {worst:.3e} (tol {GRAD_REL_L2_TOL}); launches "
        + json.dumps(launches))
    want = {name: V2_LITE.num_layers for name in launches}
    if launches != want:
        raise AssertionError(f"V2-Lite fp32 grads launched {launches}, "
                             f"expected {want}")
    if not worst <= GRAD_REL_L2_TOL:
        raise AssertionError(f"V2-Lite fp32 gradients disagree: {worst}")
    del params32, leaves, kernel_grads, loss_k, loss_p
    torch.cuda.empty_cache()
    return worst, launches


def ds_train_steps(params, tokens):
    """DS_TRAIN_STEPS Adam steps of ``mla_loss_fn`` on the bf16 V2_LITE
    ``params`` (in place), the flash kernels' counts (the merge's too) set
    to 0 just before every step and read after → {"launches": per step,
    "losses", "grad_sums": each step's fp32 sum of every gradient (a
    fingerprint of the step's gradients, taken after the step's time),
    "host_ms": the host's span of steps 2-8, "wall_s": steps 2-8, each
    from its call to the synchronize after it, "first_s": step 1 so}."""
    optimizer, step = mla_adam(V2_LITE, params)
    leaves = trainable_parameters(params)
    out = {"launches": [], "losses": [], "grad_sums": [], "host_ms": [],
           "wall_s": 0.0}
    torch.cuda.synchronize()
    for i in range(DS_TRAIN_STEPS):
        zero_flash_counts()
        t_step = time.perf_counter()
        params, _, loss = step(params, optimizer.state, tokens)
        host = time.perf_counter() - t_step
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_step
        if i:
            out["host_ms"].append(host * 1e3)
            out["wall_s"] += wall
        else:
            out["first_s"] = wall
        out["launches"].append(
            {**flash_counts(),
             "flash_dkv_merge": fbwd.merge_dkv_splits.launches})
        out["losses"].append(loss.item())
        out["grad_sums"].append(torch.stack(
            [t.grad.sum(dtype=torch.float32) for t in leaves]).cpu())
    optimizer.zero_grad(set_to_none=True)
    del optimizer, step
    return out


def run_ds_train(seed, tokens):
    """(c) 8 Adam steps of bf16 V2_LITE (weights drawn on the card from
    ``seed``): 27 / 27 / 27 flash launches a step (plus 27 merges where
    ``dkv_splits`` splits), no plain version on a CUDA tensor, a falling
    loss, ms a step, tokens/s, the host's span of a step and the peak
    memory; then the same steps again from the same initial parameters (a
    host copy), equal bit for bit (every step's loss and gradient sums,
    the final parameters), and 3 profiled steps → the record."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_mla_params(V2_LITE, torch.Generator(
        device=DEV).manual_seed(seed), device=DEV)
    leaves = trainable_parameters(params)
    init_host = [t.detach().to("cpu", copy=True) for t in leaves]
    n_params = sum(t.numel() for t in leaves)
    with plain_calls_on_card() as plain:
        first = ds_train_steps(params, tokens)
    if plain:
        raise AssertionError(f"V2-Lite training: plain versions ran on the "
                             f"card: {plain}")
    peak = torch.cuda.max_memory_allocated()
    steps = DS_TRAIN_STEPS - 1
    ms = first["wall_s"] / steps * 1e3
    tps = steps * DS_TRAIN_BATCH * DS_TRAIN_SEQ / first["wall_s"]
    splits = fbwd.dkv_splits(V2_LITE.dtype, DS_D, DS_TRAIN_BATCH, DS_HQ, 1,
                             DS_TRAIN_SEQ, sm_count())
    want = {"flash_fwd": V2_LITE.num_layers, "flash_dq": V2_LITE.num_layers,
            "flash_dkv": V2_LITE.num_layers,
            "flash_dkv_merge": V2_LITE.num_layers if splits > 1 else 0}
    losses = first["losses"]
    log(f"V2-Lite train ({n_params} parameters, {DS_TRAIN_BATCH} x "
        f"{DS_TRAIN_SEQ + 1} tokens, D=576, {splits} dK/dV splits): losses "
        f"{json.dumps(losses)}; first step {first['first_s']:.3f} s; steps "
        f"2-{DS_TRAIN_STEPS} {ms:.1f} ms/step, {tps:.0f} tokens/s; the "
        f"host's span of each step (ms) {json.dumps(first['host_ms'])}; peak "
        f"memory {peak / 2**30:.2f} GiB; launches per step "
        f"{json.dumps(first['launches'][0])}")
    if any(n != want for n in first["launches"]):
        raise AssertionError(f"V2-Lite train steps launched "
                             f"{first['launches']}, expected {want} each")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"V2-Lite training did not lower the loss: "
                             f"{losses}")
    final_host = [t.detach().to("cpu", copy=True) for t in leaves]
    with torch.no_grad():
        for t, h in zip(leaves, init_host):
            t.copy_(h.to(DEV))
    del init_host
    second = ds_train_steps(params, tokens)
    rows = [{"step": i + 1, "loss_equal": a == b,
             "grad_sums_equal": torch.equal(ga, gb)}
            for i, (a, b, ga, gb) in enumerate(zip(
                first["losses"], second["losses"], first["grad_sums"],
                second["grad_sums"]))]
    final_equal = all(torch.equal(t.detach(), h.to(DEV))
                      for t, h in zip(leaves, final_host))
    del final_host
    log(f"V2-Lite train determinism: every step's loss and gradient sums "
        f"equal {all(r['loss_equal'] and r['grad_sums_equal'] for r in rows)}"
        f"; final parameters equal bit for bit {final_equal}")
    if not final_equal or not all(r["loss_equal"] and r["grad_sums_equal"]
                                  for r in rows):
        raise AssertionError(f"V2-Lite training is not deterministic: {rows}"
                             f", final parameters equal {final_equal}")
    profile = profile_mla_steps(V2_LITE, params, tokens)
    del params, leaves
    torch.cuda.empty_cache()
    return {"parameters": n_params, "launches_per_step": first["launches"][0],
            "dkv_splits": splits, "losses": losses, "ms_per_step": ms,
            "tokens_per_s": tps, "host_ms_per_step": first["host_ms"],
            "first_step_s": first["first_s"],
            "peak_memory_gib": peak / 2**30,
            "plain_calls_on_card": 0,
            "determinism": {"steps": DS_TRAIN_STEPS, "bitwise_equal": True},
            "step_profile": profile}


def run_deepseek_training(seed):
    """Phase 21 (a)-(d), inputs from a fifteenth generator (seed + 14),
    V2_LITE's bf16 weights from ``seed`` on the card → (record, phase
    seconds)."""
    rng = np.random.default_rng(seed + 14)
    out, phase = {}, {}
    t = time.perf_counter()
    with torch.no_grad():
        out["errors"] = check_latent_all(rng)
    torch.cuda.empty_cache()
    phase["latent_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    out["grad_rel_l2_worst"], out["grad_launches"] = check_ds_train_grads(
        rng, seed)
    phase["latent_grads"] = time.perf_counter() - t
    t = time.perf_counter()
    tokens = torch.from_numpy(np.random.default_rng(seed + 14).integers(
        0, V2_LITE.vocab_size, (DS_TRAIN_BATCH, DS_TRAIN_SEQ + 1))).to(DEV)
    out["train"] = run_ds_train(seed, tokens)
    phase["latent_train"] = time.perf_counter() - t
    t = time.perf_counter()
    out["times"] = time_flash(rng, b=DS_TRAIN_BATCH, hq=DS_HQ, hkv=1,
                              s=DS_TRAIN_SEQ, d=DS_D)
    with torch.no_grad():
        q, k, v, _, _ = flash_inputs(rng, DS_TRAIN_BATCH, DS_HQ, 1,
                                     DS_TRAIN_SEQ, DS_TRAIN_SEQ, DS_D,
                                     torch.bfloat16)
        out["library_backend"] = sdpa_backend(q, k, v, is_causal=True,
                                              enable_gqa=True)
        log(f"SDPA's backend at D={DS_D}: {out['library_backend']}")
        del q, k, v
        out["merge_times"] = time_dkv_merge(rng, d=DS_D)
    phase["latent_times"] = time.perf_counter() - t
    return out, phase


# --------------------------------------------------------------------------
# Phase 22: the quantized latent attention at DeepSeek's absorbed width 576
# --------------------------------------------------------------------------

# The quantized kernels at 576 (bf16 / int8 Q; fp32 takes the 32-row
# scalar bodies), by the record entry whose `*_d576` keys carry them.
LATENT_QKERNELS = {"qattn_fwd": "qattn_fwd_latent_kernel",
                   "qflash_dq": "qflash_dq_latent_kernel",
                   "qflash_dkv": "qflash_dkv_latent_kernel"}
LATENT_QREDESIGNED = {
    "qattn_fwd": "flash_fwd_latent_kernel's frame over the payload: 8 "
                 "warps, O's lanes over two warp groups, the two warps of "
                 "a slab splitting each 32-key step's scores under a named "
                 "barrier; payload bytes double-buffered by cp.async and "
                 "widened in shared memory, 230,400 bytes (bf16 Q); an int8 "
                 "P walks the TPU's block_kv spans twice, its bytes through "
                 "the slab's P tile",
    "qflash_dq": "dq_latent_body over the payload: each 32-key tile's K and "
                 "V rows read and dequantized in registers as they load "
                 "(no scratch fits beside Q and dO), the folded column "
                 "scales and store multipliers, 8 warps",
    "qflash_dkv": "dkv_latent_body over the payload: a CTA's 32 keys of K "
                  "and V dequantized once as they load, 32-row Q / dO "
                  "steps, 8 warps, the GQA group dealt over dkv_splits "
                  "CTAs and summed in split order by flash_dkv_merge_kernel",
}
# (b)'s calls: the three over the joint [C | K_rope] latent, as phase 19
# (b) makes them, and mla_absorbed_attention over the bare 512 latent.
LATENT_PATH_CALLS = ("exact", "quantize_q", "facade", "absorbed")


def check_latent_quantized_all(rng):
    """(a) Every quantized kernel at 576, and at 512 and 320 (which run at
    576), Hq=16 over the one latent head, S=300: phase 19 (a)'s modes
    (check_quantized_width) without the full-integer pair, each twice, bit
    for bit.  → {label: errors}."""
    errs = {}
    for d in (DS_D, 512, 320):
        check_quantized_width(rng, d, (2, DS_HQ, 1, 300, 300), errs,
                              fullint=False)
    log(f"phase 22 (a): {len(errs)} checks, each bit for bit on a repeat")
    return errs


def dense_absorbed_grads(q, c, w_uk, w_uv, do):
    """The fp32 dense VJP of ``mla_absorbed_attention`` (causal, DS_SCALE)
    over the latent C [B, S, d_c]: (dq, dC)."""
    leaves = [t.detach().float().requires_grad_(True) for t in (q, c)]
    with torch.enable_grad():
        q_lat = torch.einsum("bhsd,hdc->bhsc", leaves[0], w_uk.float())
        s = torch.einsum("bhsc,btc->bhst", q_lat, leaves[1]) * DS_SCALE
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=DEV).tril()
        p = torch.softmax(s.masked_fill(~keep, -float("inf")), dim=-1)
        o = torch.einsum("bhsc,hcd->bhsd",
                         torch.einsum("bhst,btc->bhsc", p, leaves[1]),
                         w_uv.float())
        return torch.autograd.grad(o, leaves, grad_outputs=do.float())


def run_latent_path(seed):
    """(b) The quantized latent path at V2-Lite's layer 0 widths (a
    one-layer copy of V2_LITE: depth cut, not width): over the joint
    [C | K_rope] int8 ROW latent ([C | 0] as V), the exact call, the
    ``quantize_q`` call and the facade; ``mla_absorbed_attention`` over the
    bare 512 latent, int8 ROW, 16 heads of 128.  The counts set to 0 just
    before each call's forward and backward and read after; dq and the
    scale cotangents against the dense fp32 VJP on the dequantized latent;
    each launched kernel against its plain version on the call's inputs.
    → record."""
    cfg = dataclasses.replace(V2_LITE, num_layers=1)
    q_lat, k, v, (qn, c, w_uk, w_uv) = mla_joint_operands(
        seed, cfg, torch.Generator(device=DEV).manual_seed(seed),
        absorbed=True)
    g = torch.Generator(device=DEV).manual_seed(seed + 21)
    do = torch.randn(q_lat.shape, generator=g, device=DEV).to(q_lat.dtype)
    row = QuantConfig(granularity=QuantGranularity.ROW)
    kq, vq = quantize(k, row), quantize(v, row)
    out = {"launches": {}, "grads_rel_l2": {}, "kernels": {}, "seconds": {},
           "shape": "q_lat [2, 16, 2048, 576] bf16, [C | K_rope] int8 ROW "
                    "SYMMETRIC [2, 1, 2048, 576], [C | 0] int8 ROW; the "
                    "absorbed call: q [2, 16, 2048, 128] bf16 over C int8 "
                    "ROW [2, 1, 2048, 512]; V2_LITE layer 0, seed "
                    f"{seed}"}
    check_joint_calls("V2-Lite joint latent", LATENT_PATH_CALLS[:3], q_lat,
                      k, v, kq, vq, None, do, out, splits=(8, 8),
                      scale=DS_SCALE)
    # The absorbed call over the bare latent (run at 576: 512 + 64 zeros).
    cq = quantize(c[:, None], row)
    do_n = torch.randn(qn.shape, generator=g, device=DEV).to(qn.dtype)

    def absorbed(x, cs):
        return mla_absorbed_attention(
            x, dataclasses.replace(cq, scale=cs), w_uk, w_uv,
            mask=masking.CAUSAL, scale=DS_SCALE)

    for f in WIDE_COUNTED:
        f.launches = 0
    leaves = [t.detach().clone().requires_grad_(True) for t in (qn, cq.scale)]
    t0 = time.perf_counter()
    with torch.enable_grad():
        o = absorbed(*leaves)
        grads = torch.autograd.grad((o.float() * do_n.float()).sum(), leaves)
    torch.cuda.synchronize()
    out["seconds"]["absorbed"] = time.perf_counter() - t0
    counts = {f.__name__: f.launches for f in WIDE_COUNTED if f.launches}
    out["launches"]["absorbed"] = counts
    want_counts = {"qattn_fwd": 1, "qflash_dq": 1, "qflash_dkv": 1,
                   "merge_dkv_splits": 1}
    log(f"V2-Lite absorbed over the int8 512 latent: launches "
        f"{json.dumps(counts)}, {out['seconds']['absorbed']:.3f} s")
    if counts != want_counts or not (torch.isfinite(o.float()).all()
                                     and o.shape == qn.shape):
        raise AssertionError(f"latent path absorbed: launches {counts}, "
                             f"expected {want_counts}")
    with torch.no_grad():
        dq, dcl = dense_absorbed_grads(qn, dequantize(cq)[:, 0], w_uk, w_uv,
                                       do_n)
        out["grads_rel_l2"]["absorbed"] = gate_grads(
            "V2-Lite absorbed over the int8 512 latent: dq and the latent's "
            "scale cotangent vs the fp32 dense VJP on the dequantized "
            "latent", grads,
            (dq, tqa._scale_zp_cotangents(dcl[:, None], cq)[0]),
            ("dq", "c_scale"))
        del dq, dcl, o, grads
    # (The full-integer backward at 576 is phase 23 (c).)
    # The device kernels, by name, of the exact call's forward and
    # backward; a trace that recorded no kernel (PERF.md §7) is taken
    # again.
    fn, _, kv, *_ = wide_path_call("exact", k, v, kq, vq, None,
                                   scale=DS_SCALE)
    for _ in range(3):
        seen = list(device_ms_by_kernel(
            lambda: wide_call_grads(fn, q_lat, *kv, do), 2))
        families = {fam: [n for n in seen if fam in n and (
                        "576" in n or fam == "flash_dkv_merge_kernel")]
                    for fam in (*LATENT_QKERNELS.values(),
                                "flash_dkv_merge_kernel")}
        if all(families.values()):
            break
    log("V2-Lite joint latent, device kernels by the profiler: "
        + json.dumps({f: [kernel_label(n) for n in ns]
                      for f, ns in families.items()}))
    if not all(families.values()):
        raise AssertionError(f"latent path: kernels missing from the "
                             f"trace: {families}; traced: "
                             f"{sorted({kernel_label(n) for n in seen})}")
    out["device_kernels"] = {f: ns[0][:160] for f, ns in families.items()}
    return out, (q_lat, kq, vq, None, do)


def run_latent_quantized(seed):
    """Phase 22 (a)-(d), inputs from a sixteenth generator (seed + 21) →
    (record, phase seconds)."""
    rng = np.random.default_rng(seed + 21)
    out, phase = {}, {}
    t = time.perf_counter()
    with torch.inference_mode():
        out["errors"] = check_latent_quantized_all(rng)
    phase["latent_q_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    out["path"], path_inputs = run_latent_path(seed)
    phase["latent_q_path"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    with torch.inference_mode():
        out["long_context"] = run_wide_long_context(
            rng, DS_D, V2_LITE.latent_dim, DS_SCALE)
    phase["latent_q_long_context"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    with torch.no_grad():
        out["times"] = time_wide_kernels(path_inputs, DS_SCALE)
    phase["latent_q_times"] = time.perf_counter() - t
    return out, phase


# --------------------------------------------------------------------------
# Phase 23: every head dim from 1 to 576, the full-integer backward at 576
# --------------------------------------------------------------------------

# (a)'s head dims off the multiples of 16: 8 and 20 run at the kernels'
# width 32, 24, 33 and 40 at 64, 72 at 128 (the paged kernels compute the
# next multiple of 16 over the pool's own rows).
OFF_GRID_DIMS = (8, 20, 24, 33, 40, 72)
# (b): public models whose heads are off the multiples of 16, at full
# width, self-attention (label, B, heads, S, D).  Stable Diffusion 1.5's
# UNet (runwayml/stable-diffusion-v1-5, unet/config.json:
# block_out_channels 320 / 640 / 1280 over attention_head_dim 8) at its
# first level: 320 / 8 = 40 lanes over the 64 x 64 latent of a 512 px
# image; DiT-XL/2 (facebookresearch/DiT, models.py: hidden 1152, 16
# heads) at 512 px: 72 lanes over (512 / 8 / 2)^2 = 1024 patches.
PUBLIC_WIDTHS = (("sd15_unet_level1", 2, 8, 4096, 40),
                 ("dit_xl2_512px", 2, 16, 1024, 72))
# (c)'s kernels: the full-integer pair's 576 instances (levels 1 and 2)
# and, below one s8 k step, its 32-row __dp4a pair.
FULLINT_576 = {"fullint_dq": ("fullint_dq_tc_kernel", "fullint_dq32_kernel",
                              f"{FLASH_BWD_TPU}:511"),
               "fullint_dkv": ("fullint_dkv_tc_kernel",
                               "fullint_dkv32_kernel",
                               f"{FLASH_BWD_TPU}:584")}
FULLINT_576_REDESIGNED = {
    "fullint_dq": "fullint_dq_tc_kernel at D = 576 in the latent bodies' "
                  "frame: 32 query rows a CTA, 8 warps as 2 row warps x 4 "
                  "warp groups (144 dQ lanes a warp; 72 fp32 sums and, at "
                  "level 2, 72 int32 span sums a thread), 32-key steps of "
                  "K and V double-buffered by cp.async, 153,856 B",
    "fullint_dkv": "fullint_dkv_tc_kernel at D = 576: 32 keys a CTA, 8 "
                   "warps as 2 key warps x 4 warp groups (144 dK and 144 "
                   "dV lanes a warp), 32-query steps (one dO buffer at "
                   "level 1: 213,760 B), the GQA group dealt over "
                   "fullint_dkv_splits CTAs and summed in split order by "
                   "flash_dkv_merge_kernel",
}


def check_paged_width(rng, d, vtz=None):
    """(a) Both paged kernels at head dim ``d`` over two-state fp32, bf16,
    int8 and int4 pools (Hq=8 over Hkv=2) and one-state latent pages with
    a zeroed V tail of ``vtz`` lanes (default d / 8; bf16 and int8, Hq=16
    over one head), each called twice: equal bit for bit, held to the
    plain version (max abs ≤ KERNEL_TOL, TOLERANCES["fp32"] for fp32), V's
    zeroed tail zero, the pool unchanged.  → {label: max abs err}."""
    gen = device_generator(rng)
    pt, num_pages, max_pages, chunk, offset = 16, 40, 8, 48, 37
    lengths = np.asarray([1, pt, pt + 1, 3 * pt + 5, 7 * pt], np.int32)
    ln = torch.from_numpy(lengths).to(DEV)
    vtz = vtz or max(1, d // 8)
    errs = {}
    for kind, states, hq, hkv, tail in (
            ("f32", 2, 8, 2, 0), ("bf16", 2, 8, 2, 0), ("int8", 2, 8, 2, 0),
            ("int4", 1, 8, 2, 0), ("bf16", 1, 16, 1, vtz),
            ("int8", 1, 16, 1, vtz)):
        dtype = torch.float32 if kind == "f32" else torch.bfloat16
        pool, kw = paged_pool_f32(gen, "f32" if kind == "bf16" else kind,
                                  hkv, num_pages, pt, d, states)
        pool = pool.to(torch.bfloat16) if kind == "bf16" else pool
        kw.update(page_tokens=pt, v_tail_zero=tail)
        table = page_tables(rng, lengths, pt, num_pages, max_pages)
        row = page_tables(rng, [offset + chunk], pt, num_pages,
                          max_pages)[0]
        q = torch.randn((len(lengths), hq, d), generator=gen,
                        device=DEV).to(dtype)
        qp = torch.randn((hq, chunk, d), generator=gen, device=DEV).to(dtype)
        before = pool.clone()
        tol = TOLERANCES["fp32"] if kind == "f32" else KERNEL_TOL
        for name, fn, plain, args in (
                ("decode", paged_decode_attention,
                 paged_decode_attention_plain, (q, pool, table, ln)),
                ("prefill", paged_prefill_attention,
                 paged_prefill_attention_plain, (qp, pool, row, offset))):
            label = f"{name} D={d} {kind} {states}-state vtz {tail}"
            first, second = fn(*args, **kw), fn(*args, **kw)
            torch.cuda.synchronize()
            errs[label] = max_abs(first, plain(*args, **kw))
            zero_tail = not tail or not first[..., d - tail:].any()
            same = torch.equal(first, second)
            if not (errs[label] <= tol and zero_tail and same
                    and first.shape == args[0].shape):
                raise AssertionError(
                    f"paged {label}: max abs {errs[label]} (tol {tol}), "
                    f"zero tail {zero_tail}, two calls equal {same}")
        if not torch.equal(pool, before):
            raise AssertionError(f"paged D={d} {kind}: a call wrote the pool")
    return errs


def check_off_grid_all(rng):
    """(a) At each of OFF_GRID_DIMS, every kernel against its plain version,
    each called twice and equal bit for bit: the flash forward, dQ and
    dK/dV in bf16 and fp32 (Hq=4 over Hkv=2, S=150, causal); the quantized
    forward and exact backward over int8 ROW, int4 ROW (even head dims)
    and, the forward, an int8 Q (S=150, causal); the paged kernels
    (check_paged_width); the full-integer pair at levels 1 and 2 at 40 and
    72 (Hq=8 over one head, S=256, 128-wide level-2 spans), and at 576
    below one k step (S=144: the 32-row __dp4a pair).  → {label: errors}."""
    row8, row4, ch8 = qcfg(), qcfg(bits=4), qcfg(gran="channel")
    errs = {}
    for d in OFF_GRID_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            errs[f"flash d{d} {str(dtype)[6:]}"] = check_latent(
                rng, "off-grid", 1, 4, 2, 150, 150, d, dtype,
                scale=d ** -0.5)
        modes = [("int8 ROW", row8, {})] + (
            [("int4 ROW", row4, {})] if d % 2 == 0 else [])
        for label, cfg, opts in modes + [("int8 Q", row8,
                                          dict(quantize_q=True))]:
            errs[f"qattn d{d} {label}"] = check_qattn(
                rng, f"D={d} {label}", 1, 4, 2, 150, 150, d, cfg, cfg,
                repeat=True, **opts)
        for label, cfg, opts in modes:
            errs[f"qflash d{d} {label}"] = check_qflash(
                rng, f"D={d} {label}", 1, 4, 2, 150, 150, d, cfg, cfg,
                repeat=True)
        errs.update({f"paged {k}": v
                     for k, v in check_paged_width(rng, d).items()})
    spans = BlockSizes(block_kv_dq=128, block_q_dkv=128)
    for d in (40, 72):
        for level2 in (False, True):
            errs[f"fullint d{d} l{2 if level2 else 1}"] = check_fullint(
                rng, f"D={d} ROW K / CHANNEL V", 1, 8, 1, 256, d, row8, ch8,
                level2, spans, repeat=True)
    errs[f"fullint d{DS_D} w16 l2"] = check_fullint(
        rng, f"D={DS_D} ROW K / CHANNEL V, S=144", 1, DS_HQ, 1, 144, DS_D,
        row8, ch8, True, BlockSizes(block_kv_dq=512, block_q_dkv=512),
        repeat=True)
    log(f"phase 23 (a): {len(errs)} checks, each bit for bit on a repeat")
    return errs


def time_public_width(q, k, v, do):
    """(b)'s kernels alone on the call's inputs (FULL, bf16): events and the
    profiler's device ms, the plain version's ms, the bound and SDPA's
    forward / backward on the same bf16 inputs → {name: times}."""
    b, h, s, d = q.shape
    rr = row_ranges_tensor(masking.FULL, s, s, None, DEV)
    kw = dict(scale=d ** -0.5)
    o, lse = flash_fwd(q, k, v, rr, **kw)
    di = (do.float() * o).sum(-1)
    args = (q, k, v, do, lse, di, rr)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qg, kg, vg)
    library = {"fwd": lambda: F.scaled_dot_product_attention(q, k, v),
               "bwd": lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                  retain_graph=True)}
    pairs, elems, rows = b * h * s * s, b * h * s * d, b * h * s
    read_bwd = 2 * 4 * elems + 2 * 4 * rows
    work = {"flash_fwd": (4 * d * pairs, 2 * 3 * elems + 4 * elems + 4 * rows),
            "flash_dq": (6 * d * pairs, read_bwd + 4 * elems),
            "flash_dkv": (8 * d * pairs, read_bwd + 4 * 2 * elems)}
    fns = {"flash_fwd": (lambda: flash_fwd(q, k, v, rr, **kw),
                         lambda: flash_attention_forward_plain(q, k, v, rr,
                                                               **kw)),
           "flash_dq": (lambda: flash_dq(*args, **kw),
                        lambda: flash_attention_dq_plain(*args, **kw)),
           "flash_dkv": (lambda: flash_dkv(*args, **kw),
                         lambda: flash_attention_dkv_plain(*args, **kw))}
    times = {}
    for name, (kernel, plain) in fns.items():
        lib = library["fwd" if name == "flash_fwd" else "bwd"]
        t = {"plain_ms": time_ms(plain, 1, warmup=1),
             "ms": time_ms(kernel, 10, warmup=2),
             "library_ms": time_ms(lib, 10, warmup=2)}
        t["ms_2"] = time_ms(kernel, 10, warmup=0)
        by = device_ms_by_label(kernel, 10) or device_ms_by_label(kernel, 10)
        t["device_ms_by_kernel"] = by
        t["device_ms"] = (sum(by.values()) if by else
                          measure_held(kernel, iters=10, warmup=0) * 1e3)
        t["library_device_ms"] = device_ms(lib, 10)
        t["bound_ms"], t["bound_by"] = bound_of(*work[name])
        t["width"] = flash_width(d)
        t["body"] = {"flash_fwd": fwd_body, "flash_dq": dq_body,
                     "flash_dkv": dkv_body}[name](q.dtype, d)
        times[name] = t
    return times


def run_public_widths(rng):
    """(b) ``MultiHeadAttention`` forward and backward at PUBLIC_WIDTHS'
    shapes in bf16: one forward, one dQ and one dK/dV launch a call, O and
    the gradients held to the plain versions at the bf16 gate; the same
    call in fp32 against the dense fp32 VJP (rel L2 ≤ GRAD_REL_L2_TOL);
    the kernels' times (time_public_width).  → {label: record}."""
    out = {}
    for label, b, h, s, d in PUBLIC_WIDTHS:
        q, k, v, do, _ = flash_inputs(rng, b, h, h, s, s, d, torch.bfloat16)
        mha = MultiHeadAttention(AttentionDescriptor(
            head_dim=d, num_q_heads=h, num_kv_heads=h, mask=masking.FULL))
        rec = {"shape": f"B={b} H={h} S={s} D={d} FULL self-attention",
               "width": flash_width(d)}
        grads = {}
        for dtype in (torch.bfloat16, torch.float32):
            leaves = [x.detach().to(dtype).requires_grad_(True)
                      for x in (q, k, v)]
            zero_flash_counts()
            with torch.enable_grad():
                o = mha(*leaves)
                grads[dtype] = torch.autograd.grad(o, leaves, do.to(dtype))
            torch.cuda.synchronize()
            counts = flash_counts()
            rec[f"launches_{str(dtype)[6:]}"] = counts
            if tuple(counts.values()) != (1, 1, 1):
                raise AssertionError(f"{label} {dtype}: launches {counts}")
            if dtype == torch.bfloat16:
                rr = row_ranges_tensor(masking.FULL, s, s, None, DEV)
                kw = dict(scale=d ** -0.5)
                o_ref, l_ref = flash_attention_forward_plain(q, k, v, rr,
                                                             **kw)
                di = (do.float() * o_ref).sum(-1)
                pargs = (q, k, v, do, l_ref, di, rr)
                want = (o_ref, flash_attention_dq_plain(*pargs, **kw)[0],
                        *flash_attention_dkv_plain(*pargs, **kw))
                errs = {n: rel_err(g, w) for n, g, w in zip(
                    ("o", "dq", "dk", "dv"), (o, *grads[dtype]), want)}
                rec["rel_err_bf16_vs_plain"] = errs
                del want, o_ref, pargs
                if not all(e <= FLASH_TOL[torch.bfloat16]
                           for e in errs.values()):
                    raise AssertionError(f"{label} bf16 vs plain: {errs}")
            else:
                ref = [torch.cat(p) for p in zip(*(
                    reference_attention_vjp(
                        q[i:i + 1].float(), k[i:i + 1].float(),
                        v[i:i + 1].float(), do[i:i + 1].float(),
                        mask=masking.FULL)
                    for i in range(b)))]
                errs = {n: rel_l2(g, w) for n, g, w in zip(
                    ("dq", "dk", "dv"), grads[dtype], ref)}
                rec["grad_rel_l2_fp32_vs_dense"] = errs
                del ref
                if not all(e <= GRAD_REL_L2_TOL for e in errs.values()):
                    raise AssertionError(f"{label} fp32 grads: {errs}")
            del o, leaves
        del grads
        row = QuantConfig(granularity=QuantGranularity.ROW)
        with torch.no_grad():
            rec["times"] = time_public_width(q, k, v, do)
            # The quantized forward and exact pair at the same shape over
            # int8 ROW K / V (folded, causal), as phases 19 and 22 time
            # them.
            rec["quantized_times"] = time_wide_kernels(
                (q, quantize(k.float(), row), quantize(v.float(), row), None,
                 do), d ** -0.5, fam=f"d{d}")
        log(f"phase 23 (b) {label}: " + json.dumps(rec))
        out[label] = rec
        torch.cuda.empty_cache()
    return out


def run_fullint_576(seed):
    """(c) ``quantized_flash_attention(..., bwd_fullint=True)`` over
    V2_LITE layer 0's joint [C | K_rope] latent (B=2, Hq=16 over one
    latent head, S=2048, D=576, FULL; bf16 Q; int8 SYMMETRIC ROW K and
    CHANNEL V), at levels 1 and 2 (MFA_BWD_FULLINT_LEVEL=2): the counts set
    to 0 just before each call and read after (one forward, one dQ, one
    dK/dV and one merge); dq and the scale cotangents against the dense
    fp32 VJP on the dequantized K/V (rel L2 ≤ QBWD_TOL); a second call
    equal bit for bit; each kernel against its plain version on the call's
    inputs; the kernels' device names under the profiler; their times
    (time_wide_kernels' full-integer part).  → record."""
    cfg = dataclasses.replace(V2_LITE, num_layers=1)
    q_lat, k, v = mla_joint_operands(
        seed, cfg, torch.Generator(device=DEV).manual_seed(seed))
    g = torch.Generator(device=DEV).manual_seed(seed + 23)
    do = torch.randn(q_lat.shape, generator=g, device=DEV).to(q_lat.dtype)
    kq = quantize(k, QuantConfig(granularity=QuantGranularity.ROW))
    vq = quantize(v, QuantConfig(granularity=QuantGranularity.CHANNEL))
    if not fbwd.fullint_backward_supported(q_lat, kq, vq, masking.FULL,
                                           None, None):
        raise AssertionError("the full-integer backward's preconditions do "
                             "not hold for the 576 call")
    out = {"launches": {}, "grads_rel_l2": {}, "kernels": {}, "seconds": {},
           "splits": fbwd.fullint_dkv_splits(DS_D, 2, DS_HQ, 1, DEC_S,
                                             sm_count()),
           "shape": "q_lat [2, 16, 2048, 576] bf16, [C | K_rope] int8 ROW "
                    "SYMMETRIC [2, 1, 2048, 576], [C | 0] int8 CHANNEL "
                    f"SYMMETRIC, FULL; V2_LITE layer 0, seed {seed}"}
    with torch.no_grad():
        dq, dk, dv = (torch.cat(p) for p in zip(*(
            reference_attention_vjp(
                q_lat[i:i + 1].float(), dequantize(kq)[i:i + 1],
                dequantize(vq)[i:i + 1], do[i:i + 1].float(),
                mask=masking.FULL, scale=DS_SCALE)
            for i in range(q_lat.shape[0]))))
        want = (dq, tqa._scale_zp_cotangents(dk, kq)[0],
                tqa._scale_zp_cotangents(dv, vq)[0])
        del dk, dv
    fi = quantized_call(kq, vq, masking.FULL, False, True, DS_SCALE)
    level_env = os.environ.get("MFA_BWD_FULLINT_LEVEL")
    try:
        for level in (1, 2):
            os.environ["MFA_BWD_FULLINT_LEVEL"] = str(level)
            tag = f"level{level}"
            for f in WIDE_COUNTED:
                f.launches = 0
            t0 = time.perf_counter()
            o, grads = wide_call_grads(fi, q_lat, kq, vq, do)
            torch.cuda.synchronize()
            out["seconds"][tag] = time.perf_counter() - t0
            counts = {f.__name__: f.launches for f in WIDE_COUNTED
                      if f.launches}
            out["launches"][tag] = counts
            want_counts = {"qattn_fwd": 1, "fullint_dq": 1, "fullint_dkv": 1,
                           "merge_dkv_splits": 1}
            log(f"V2-Lite joint latent, bwd_fullint=True level {level}: "
                f"launches {json.dumps(counts)}, {out['seconds'][tag]:.3f} "
                "s (first call)")
            if counts != want_counts or not torch.isfinite(o.float()).all():
                raise AssertionError(f"fullint 576 level {level}: launches "
                                     f"{counts}, expected {want_counts}")
            again = wide_call_grads(fi, q_lat, kq, vq, do)[1]
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f"fullint 576 level {level}: a second "
                                     "call differs")
            out["grads_rel_l2"][tag] = gate_grads(
                f"V2-Lite joint latent, bwd_fullint=True level {level}: dq, "
                "K's and V's scale cotangents vs the fp32 dense VJP on the "
                "dequantized K/V", grads, want,
                ("dq", "dk_scale", "dv_scale"))
            del o, grads, again
            # Each kernel the call launched, on the call's inputs, against
            # its plain version.
            fo, flse = quantized_flash_attention_forward(
                q_lat, kq, vq, scale=DS_SCALE)
            (a1, k1), (a2, k2) = fbwd.fullint_arguments(
                q_lat, kq, vq, fo, flse, do, scale=DS_SCALE,
                int8_grads=level == 2)
            errs = {}
            for name, a, kw, outs in (("fullint_dq", a1, k1, ("dq",)),
                                      ("fullint_dkv", a2, k2, ("dk", "dv"))):
                got = getattr(fbwd, name)(*a, **kw)
                torch.cuda.synchronize()
                want_k = getattr(fbwd, f"{name}_plain")(*a, **kw)
                if torch.is_tensor(got):
                    got, want_k = (got,), (want_k,)
                errs[name] = check_bwd_pair(
                    f"fullint 576 level {level}: {name} (width "
                    f"{kw['width']}, {fullint_body(DS_D, kw['width'])})",
                    got, want_k, outs)
                del got, want_k
            out["kernels"][tag] = errs
            del fo, flse, a1, a2
    finally:
        if level_env is None:
            os.environ.pop("MFA_BWD_FULLINT_LEVEL", None)
        else:
            os.environ["MFA_BWD_FULLINT_LEVEL"] = level_env
    del want
    torch.cuda.empty_cache()
    for _ in range(3):
        seen = list(device_ms_by_kernel(
            lambda: wide_call_grads(fi, q_lat, kq, vq, do), 2))
        families = {fam: [n for n in seen if fam in n and (
                        "576" in n or fam == "flash_dkv_merge_kernel")]
                    for fam in ("fullint_dq_tc_kernel",
                                "fullint_dkv_tc_kernel",
                                "flash_dkv_merge_kernel")}
        if all(families.values()):
            break
    # The launch counts above show the kernels ran; a trace the profiler
    # left empty (PERF.md §7) is logged, not failed.
    log("fullint 576, device kernels by the profiler: " + json.dumps(
        {f: [kernel_label(n) for n in ns] for f, ns in families.items()}))
    out["device_kernels"] = {f: ns[0][:160] if ns else "not traced"
                             for f, ns in families.items()}
    with torch.no_grad():
        out["times"] = time_wide_kernels((q_lat, kq, None, vq, do), DS_SCALE,
                                         fullint_only=True)
    return out


def run_width_faults(seed, dec_lens):
    """Phase 23 (a)-(c), inputs from a seventeenth generator (seed + 22),
    and the paged kernels' times at 40 and 72 (phase 1's decode lengths,
    the prefill's 256-row chunk at offset 512) → (record, phase
    seconds)."""
    rng = np.random.default_rng(seed + 22)
    out, phase = {}, {}
    t = time.perf_counter()
    with torch.inference_mode():
        out["errors"] = check_off_grid_all(rng)
    phase["width_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    out["public"] = run_public_widths(rng)
    phase["width_public"] = time.perf_counter() - t
    t = time.perf_counter()
    out["fullint"] = run_fullint_576(seed)
    phase["width_fullint_576"] = time.perf_counter() - t
    t = time.perf_counter()
    with torch.inference_mode():
        out["paged_times"] = {
            f"d{d}": {"decode": time_decode(rng, dec_lens, d=d),
                      "prefill": time_prefill(rng, 512, d=d)}
            for d in (40, 72)}
    phase["width_paged_times"] = time.perf_counter() - t
    return out, phase


# --------------------------------------------------------------------------
# Phase 24: the flash trio and the paged pair above 576 (split-D kernels)
# --------------------------------------------------------------------------

SPLIT_D_SOURCE = ("metal_flash_attention_plus_tpu_torch/csrc/"
                  "split_d_attention.cu")
# (a)'s widths: 580 (run at 592, zero-padded), 608, 640, 1024 and 1152;
# (b)'s: 640 and 1024.
SPLIT_D_DIMS = (580, 608, 640, 1024, 1152)
SPLIT_D_TIMED = (640, 1024)
SPLIT_D_KERNELS = {"flash_fwd": "split_d_fwd_kernel",
                   "flash_dq": "split_d_dq_kernel",
                   "flash_dkv": "split_d_dkv_kernel",
                   "paged_decode": "split_d_decode_kernel",
                   "paged_prefill": "split_d_prefill_kernel"}
SPLIT_D_REPLACES = {"flash_fwd": f"{FLASH_TPU}:546",
                    "flash_dq": f"{FLASH_BWD_TPU}:77",
                    "flash_dkv": f"{FLASH_BWD_TPU}:954",
                    "paged_decode": f"{TPU_FILE}:209",
                    "paged_prefill": f"{TPU_FILE}:306"}
SPLIT_D_DESIGN = (
    "O's (dQ's, dK's and dV's) lanes split over CTAs, 256 a CTA; the "
    "scores summed over the whole head dim in 32-lane chunks, bf16 on "
    "mma.sync through a 4-stage cp.async ring, fp32 on scalar FMAs; P "
    "applied to the CTA's slice, fetched under the scores; the scores "
    "recomputed once a slice; the forward's KV axis split where the grid "
    "leaves SMs idle, then split_d_fwd_merge_kernel")
# Perceiver IO's image cross-attention (deepmind/vision-perceiver-*,
# Hugging Face PerceiverConfig: 512 latents of d_latents 1024 over one
# cross-attention head, attending to 224 x 224 inputs): B, H, Sq, Skv, D.
PERCEIVER = (1, 1, 512, 224 * 224, 1024)
# (c)'s model: the flagship's widths with 8 query heads of 640 over 2 KV
# heads; depth cut to 2 layers.
SPLIT_D_CFG = TransformerConfig(num_layers=2, num_heads=8, num_kv_heads=2,
                                head_dim=640)
SPLIT_D_TRAIN_STEPS = 4


def split_d_cases():
    """(label, B, Hq, Hkv, Sq, Skv, D, options) of (a): at every width a
    group of 16 over one head (causal) and 4 over 2 interleaved under a
    causal window (row ranges starting mid-tile); at 640 a bias with dbias
    over an odd Skv and sparse rows with an empty one; at 1024 a full mask
    over Skv > Sq; one small case at 2048.  The forward's static-max mode
    runs in every case without a bias (check_latent)."""
    seg = masking.build_segment_ranges(np.repeat(np.arange(4), 50))
    seg[77] = (10, 10)
    cases = []
    for d in SPLIT_D_DIMS:
        cases += [
            (f"gqa16_causal_d{d}", 1, 16, 1, 200, 200, d, {}),
            (f"gqa4_2_window_interleaved_d{d}", 1, 4, 2, 200, 200, d, dict(
                mask=masking.sliding_window(64, causal=True),
                interleaved=True))]
    return cases + [
        ("bias_dbias_d640", 1, 4, 2, 100, 131, 640,
         dict(bias_shape=(1, 4, 100, 131))),
        ("segments_empty_row_d640", 1, 4, 2, 200, 200, 640, dict(
            mask=masking.MaskSpec(masking.MaskKind.SPARSE_RANGES),
            ranges=seg)),
        ("full_rect_d1024", 1, 4, 2, 96, 160, 1024, dict(mask=masking.FULL)),
        ("small_d2048", 1, 2, 1, 64, 64, 2048, {}),
    ]


def check_split_d_launches(rng):
    """(a) The counts of one call of each new path at D = 640, set to 0
    just before it and read after: ``flash_attention``'s and
    ``MultiHeadAttention``'s forward and backward (16 q heads over one,
    causal, bf16: one forward, one dQ, one dK/dV and one merge each, the
    two equal bit for bit) and one decode (bf16 latent pages: the
    wrapper's one launch, which the profiler shows as split_d_decode_kernel
    then paged_decode_merge_kernel) → {path: counts}."""
    q, k, v, do, _ = flash_inputs(rng, 1, 16, 1, 256, 256, 640,
                                  torch.bfloat16)
    counted = (*FLASH_KERNELS, fbwd.merge_dkv_splits)
    mha = MultiHeadAttention(AttentionDescriptor(
        head_dim=640, num_q_heads=16, num_kv_heads=1, mask=masking.CAUSAL))
    runs = {}
    for name, call in (
            ("flash_attention",
             lambda *x: flash_attention(*x, mask=masking.CAUSAL)),
            ("MultiHeadAttention", mha)):
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        for f in counted:
            f.launches = 0
        with torch.enable_grad():
            o = call(*leaves)
            grads = torch.autograd.grad(o, leaves, do)
        torch.cuda.synchronize()
        counts = {f.__name__: f.launches for f in counted}
        if counts != {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1,
                      "merge_dkv_splits": 1}:
            raise AssertionError(f"split-D {name} launches {counts}")
        runs[name] = (counts, (o, *grads))
    flash = runs["flash_attention"][0]
    same_bits("split-D MultiHeadAttention vs flash_attention",
              runs["flash_attention"][1], runs["MultiHeadAttention"][1])
    del runs
    pt, num_pages, max_pages = 64, 40, 16
    lengths = [300, 1000, 77, 513]
    pool, _ = mla_pool(rng, False, num_pages, pt, 640)
    table = page_tables(rng, lengths, pt, num_pages, max_pages)
    ln = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    qd = torch.randn((4, 16, 640), generator=device_generator(rng),
                     device=DEV).to(torch.bfloat16)
    kw = dict(page_tokens=pt, v_tail_zero=64)

    def decode():
        return paged_decode_attention(qd, pool, table, ln, **kw)

    paged_decode_attention.launches = 0
    decode()
    torch.cuda.synchronize()
    dec = {"paged_decode": paged_decode_attention.launches}
    if dec != {"paged_decode": 1}:
        raise AssertionError(f"split-D decode launches {dec}")
    names = set()
    for _ in range(3):
        names = set(device_ms_by_label(decode, 1))
        if names:
            break
    # An empty trace (PERF.md §7) is logged, not failed: the counts above
    # show the call ran.
    dec["device_kernels"] = sorted(names) or "not traced"
    if names and not {SPLIT_D_KERNELS["paged_decode"], PAGED_MERGE} <= names:
        raise AssertionError(f"split-D decode ran {sorted(names)}")
    log("phase 24 (a) launches: " + json.dumps({"flash_attention": flash,
                                                 "decode": dec}) +
        "; MultiHeadAttention the same counts, its O and gradients bit for "
        "bit flash_attention's")
    return {"flash_attention": flash, "multi_head_attention": flash,
            "decode": dec}


def check_split_d_all(rng):
    """(a) Every case of ``split_d_cases`` in bf16 and fp32 through
    ``check_latent`` (each kernel called twice, equal bit for bit, held to
    its plain version at the flash gates), and the paged pair at each
    width (``check_paged_width``: fp32, bf16, int8 and int4 pools, latent
    pages; latent pages with 64 zeroed V lanes at 640 and 1088, two-state
    pages at 608) → {label: errors}."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, hq, hkv, sq, skv, d, kw in split_d_cases():
            errs[f"flash {label} {str(dtype)[6:]}"] = check_latent(
                rng, label, b, hq, hkv, sq, skv, d, dtype, scale=d ** -0.5,
                **kw)
    for d in SPLIT_D_DIMS + (1088,):
        errs.update({f"paged {k}": v for k, v in check_paged_width(
            rng, d, vtz=64 if d in (640, 1088) else None).items()})
    log(f"phase 24 (a): {len(errs)} checks, each bit for bit on a repeat")
    return errs


# The split-D forward's merge (phase 24 (b) and 25 (b): Perceiver IO's
# forwards split their KV axis).
FWD_MERGE_KERNEL = "split_d_fwd_merge_kernel"
FWD_SPLIT_COUNTED = (flash_fwd, qattn_fwd, tfa.merge_fwd_splits)


def split_launches(call):
    """One ``call`` with the split-D forwards' counts (kernels and merge)
    set to 0 just before and read after → {name: launches}."""
    for f in FWD_SPLIT_COUNTED:
        f.launches = 0
    out = call()
    torch.cuda.synchronize()
    return out, {f.__name__: f.launches for f in FWD_SPLIT_COUNTED
                 if f.launches}


def check_fwd_merge(label, call, kv_heads, vstore=None):
    """The merge alone on the partials ``call``'s split-D forward leaves
    (the workspace the wrapper allocates, kept as it allocates it; the
    forward's ``kv_heads`` and V_STORE multipliers ``vstore``): against
    ``merge_fwd_splits_plain`` (max abs err over O and the finite L), two
    calls equal bit for bit, events and device ms beside its plain version
    and its bound (ws read once, O and L written once; no single PyTorch
    call computes it) → record."""
    made = []
    alloc = tfa.split_d_fwd_workspace

    def keep(shape, splits, device):
        ws = alloc(shape, splits, device)
        made.append((ws, tuple(shape)))
        return ws

    tfa.split_d_fwd_workspace = tqa.split_d_fwd_workspace = keep
    try:
        call()
    finally:
        tfa.split_d_fwd_workspace = tqa.split_d_fwd_workspace = alloc
    torch.cuda.synchronize()
    ws, shape = made[-1]
    o = torch.empty(shape, dtype=torch.float32, device=DEV)
    lse = torch.empty(shape[:3], dtype=torch.float32, device=DEV)
    kernel = lambda: tfa.merge_fwd_splits(  # noqa: E731
        ws, o, lse, kv_heads=kv_heads, vstore=vstore)
    plain = lambda: tfa.merge_fwd_splits_plain(  # noqa: E731
        ws, shape, vstore=vstore)
    kernel()
    first = (o.clone(), lse.clone())
    kernel()
    torch.cuda.synchronize()
    same_bits(f"{label} merge", first, (o, lse))
    o_ref, l_ref = plain()
    live = torch.isfinite(l_ref)
    if not torch.equal(torch.isfinite(lse), live):
        raise AssertionError(f"{label} merge: L's empty rows differ")
    err = max(max_abs(o, o_ref), max_abs(lse[live], l_ref[live]))
    if not err <= 2e-5 * max(1.0, o_ref.abs().max().item()):
        raise AssertionError(f"{label} merge: max abs err {err}")
    t = {"max_abs_err": err, "splits": ws.shape[1],
         "ms": time_ms(kernel, 20, warmup=2),
         "plain_ms": time_ms(plain, 3, warmup=1), "library_ms": None,
         "library": "none (no single PyTorch call merges the runs)"}
    t["device_ms"] = sum(device_ms_by_label(kernel, 20).values()) or None
    nbytes = 4 * (ws.numel() + o.numel() + lse.numel()
                  + (0 if vstore is None else vstore.numel()))
    t["bound_ms"], t["bound_by"] = bound_of(
        2 * ws.shape[0] * ws.shape[1] * (shape[3] + 2), nbytes)
    log(f"{label} merge ({FWD_MERGE_KERNEL}): " + json.dumps(t))
    return t


def time_perceiver(rng):
    """(b) The forward at Perceiver IO's image cross-attention (PERCEIVER,
    FULL, bf16; its KV axis split: ``split_d_fwd_splits``): one call's
    launches (the counts set to 0 just before and read after: one kernel,
    one merge), O and L against the plain version at the flash gates, two
    calls equal bit for bit, events, the profiler's device ms, the plain
    version, SDPA (its backend named), the bound, with ``--parent`` in
    turns on the parent's library (one walk), and the merge alone
    (``check_fwd_merge``) → times."""
    b, h, sq, skv, d = PERCEIVER
    gen = device_generator(rng)
    q = torch.randn((b, h, sq, d), generator=gen, device=DEV).to(
        torch.bfloat16)
    k, v = (torch.randn((b, h, skv, d), generator=gen, device=DEV).to(
        torch.bfloat16) for _ in range(2))
    rr = row_ranges_tensor(masking.FULL, sq, skv, None, DEV)
    kw = dict(scale=d ** -0.5)
    kernel = lambda: flash_fwd(q, k, v, rr, **kw)  # noqa: E731
    splits = tfa.split_d_fwd_splits(d, b, h, sq, skv, sm_count())
    out, launches = split_launches(kernel)
    if splits < 2 or launches != {"flash_fwd": 1, "merge_fwd_splits": 1}:
        raise AssertionError(f"Perceiver forward: {splits} runs, launches "
                             f"{launches}")
    same_bits("Perceiver forward (split_d, its KV axis split)", out,
              kernel())
    plain = lambda: flash_attention_forward_plain(  # noqa: E731
        q, k, v, rr, **kw)
    errs = check_pair(f"Perceiver forward (split_d, {splits} runs)", out,
                      plain())
    del out
    t = {"plain_ms": time_ms(plain, 3, warmup=1),
         "ms": time_ms(kernel, 5, warmup=1),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             q, k, v), 10),
         "splits": splits, "launches": launches,
         "rel_err": errs[0], "max_abs_err": errs[2]}
    t["ms_2"] = time_ms(kernel, 5, warmup=0)
    t["device_ms_by_kernel"] = device_ms_by_label(kernel, 3)
    t["device_ms"] = (sum(t["device_ms_by_kernel"].values())
                      or measure_held(kernel, iters=3, warmup=0) * 1e3)
    t["library_backend"] = sdpa_backend(q, k, v)
    pairs = b * h * sq * skv
    t["bound_ms"], t["bound_by"] = bound_of(
        4 * d * pairs, 2 * d * (b * h * (sq + 2 * skv)) + 4 * b * h * sq
        * (d + 1))
    t["shape"] = (f"B={b} H={h} Sq={sq} Skv={skv} D={d} FULL bf16 "
                  "(Perceiver IO image cross-attention)")
    parent_turns("flash_fwd Perceiver IO (D=1024)", t, kernel, 5,
                 device=True)
    t["merge"] = check_fwd_merge("Perceiver forward", kernel, h)
    log("phase 24 (b) Perceiver IO forward: " + json.dumps(t))
    return t


def run_split_d_path(seed, rng):
    """(c) SPLIT_D_CFG (head dim 640, 8 q heads over 2, 2 layers, random
    weights from ``seed``): the cached logits against the fp32 forward
    (rel L2 ≤ LOGITS_REL_L2_TOL), phase 5's 8 requests served (counts set
    to 0 just before, read after: every prefill and decode call of each
    layer on the split-D paged kernels), the fp32 gradients through the
    kernels against plain attention (≤ GRAD_REL_L2_TOL), SPLIT_D_TRAIN_STEPS
    bf16 train steps (one forward, dQ and dK/dV a layer a step, the loss
    lower) and a rerun of them equal bit for bit → record."""
    cfg = SPLIT_D_CFG
    d = cfg.head_dim
    bodies = {"flash": fwd_body(cfg.dtype, d),
              "decode": decode_body(cfg.dtype, d),
              "prefill": prefill_body(cfg.dtype, d, 2, 0)}
    if set(bodies.values()) != {"split_d"}:
        raise AssertionError(f"head dim {d} routes {bodies}")
    params = init_params(cfg, torch.Generator().manual_seed(seed + 24),
                         device=DEV)
    out = {"config": dataclasses.asdict(cfg) | {
        "dtype": str(cfg.dtype), "block_sizes": None},
        "reduced": [f"depth cut to {cfg.num_layers} layers",
                    "random weights from the seed"], "bodies": bodies}
    with torch.inference_mode():
        out["logits_rel_l2"] = check_logits(cfg, params, rng,
                                            label="split-D serving")
    t0 = time.perf_counter()
    launches, stats, _, rates = run_engine(cfg, params, seed,
                                           label="split-D engine")
    out.update(serve_launches=launches, serve_rates=rates,
               serve_s=time.perf_counter() - t0,
               serve_calls={k: stats[k] for k in ("prefill_calls",
                                                  "decode_calls")})
    out["grad_rel_l2_worst"] = check_train_grads(cfg, params, rng)
    init = clone_params(params)
    tokens = train_tokens(cfg, seed, DEV)
    optimizer = torch.optim.Adam(trainable_parameters(params), lr=3e-3)
    step = make_train_step(cfg, optimizer)
    counted = (*FLASH_KERNELS, fbwd.merge_dkv_splits)
    for f in counted:
        f.launches = 0
    losses, t0 = [], time.perf_counter()
    for _ in range(SPLIT_D_TRAIN_STEPS):
        params, _, loss = step(params, optimizer.state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["train_launches"] = {f.__name__: f.launches for f in counted}
    out["train_losses"] = [x.item() for x in losses]
    want = cfg.num_layers * SPLIT_D_TRAIN_STEPS
    if (any(out["train_launches"][f.__name__] != want
            for f in FLASH_KERNELS)
            or not all(np.isfinite(out["train_losses"]))
            or not out["train_losses"][-1] < out["train_losses"][0]):
        raise AssertionError(f"split-D training: launches "
                             f"{out['train_launches']}, losses "
                             f"{out['train_losses']}")
    rows, final = train_twice(cfg, init, tokens, SPLIT_D_TRAIN_STEPS)
    same = not any(r["params_differ"] or r["grads_differ"]
                   or r["losses"][0] != r["losses"][1] for r in rows)
    out["rerun_bitwise_equal"] = same and (params_digest(final)
                                           == params_digest(params))
    if not out["rerun_bitwise_equal"]:
        raise AssertionError("split-D training is not deterministic")
    log("phase 24 (c) head dim 640 path: " + json.dumps(
        {k: out[k] for k in ("logits_rel_l2", "serve_launches",
                             "serve_rates", "grad_rel_l2_worst",
                             "train_launches", "train_losses", "train_s",
                             "rerun_bitwise_equal")}))
    return out


def split_d_errors(errors, name):
    """(label, max abs err) of phase 24 (a)'s checks of one kernel."""
    kind = name.split("_")[1]
    if name.startswith("paged"):
        return [(k, e) for k, e in errors.items()
                if k.startswith(f"paged {kind}")]
    outs = {"fwd": ("o", "l", "o_row_max", "l_row_max"),
            "dq": ("dq", "dbias"), "dkv": ("dk", "dv")}[kind]
    return [(k, e[1]) for k, errs in errors.items() if k.startswith("flash")
            for o, e in errs.items() if o in outs]


def run_split_d(seed, dec_lens):
    """Phase 24 (a)-(c), inputs from an eighteenth generator (seed + 23)
    → (record, phase seconds)."""
    rng = np.random.default_rng(seed + 23)
    out, phase = {}, {}
    t = time.perf_counter()
    with torch.no_grad():
        out["errors"] = check_split_d_all(rng)
    out["launches"] = check_split_d_launches(rng)
    torch.cuda.empty_cache()
    phase["split_d_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    out["times"] = {}
    for d in SPLIT_D_TIMED:
        out["times"][f"d{d}"] = time_flash(rng, b=DS_TRAIN_BATCH, hq=DS_HQ,
                                           hkv=1, s=DS_TRAIN_SEQ, d=d)
        with torch.no_grad():
            q, k, v, _, _ = flash_inputs(rng, DS_TRAIN_BATCH, DS_HQ, 1,
                                         DS_TRAIN_SEQ, DS_TRAIN_SEQ, d,
                                         torch.bfloat16)
            out["times"][f"d{d}"]["library_backend"] = sdpa_backend(
                q, k, v, is_causal=True, enable_gqa=True)
            del q, k, v
        out["times"][f"d{d}"]["splits"] = fbwd.dkv_splits(
            torch.bfloat16, d, DS_TRAIN_BATCH, DS_HQ, 1, DS_TRAIN_SEQ,
            sm_count())
        with torch.inference_mode():
            out["times"][f"d{d}"].update(time_mla_paged(
                rng, dec_lens, hq=DS_HQ, d=d, vtz=64, scale=d ** -0.5,
                label=f"split-D D={d}", turns=False))
        torch.cuda.empty_cache()
    with torch.no_grad():
        out["perceiver"] = time_perceiver(rng)
    torch.cuda.empty_cache()
    phase["split_d_times"] = time.perf_counter() - t
    t = time.perf_counter()
    out["path"] = run_split_d_path(seed, rng)
    torch.cuda.empty_cache()
    phase["split_d_path"] = time.perf_counter() - t
    return out, phase


# --------------------------------------------------------------------------
# Phase 25: the quantized attention above 576 (split-D kernels)
# --------------------------------------------------------------------------

QSPLIT_SOURCES = {
    "qattn_fwd": "metal_flash_attention_plus_tpu_torch/csrc/"
                 "split_d_quantized.cu",
    **{f: "metal_flash_attention_plus_tpu_torch/csrc/split_d_quantized_bwd.cu"
       for f in ("qflash_dq", "qflash_dkv", "fullint_dq", "fullint_dkv")}}
QSPLIT_KERNELS = {"qattn_fwd": "split_d_qattn_kernel",
                  "qflash_dq": "split_d_qdq_kernel",
                  "qflash_dkv": "split_d_qdkv_kernel",
                  "fullint_dq": "split_d_fullint_dq_kernel",
                  "fullint_dkv": "split_d_fullint_dkv_kernel"}
QSPLIT_REPLACES = {"qattn_fwd": f"{QATTN_TPU}:87",
                   "qflash_dq": f"{FLASH_BWD_TPU}:77",
                   "qflash_dkv": f"{FLASH_BWD_TPU}:954",
                   "fullint_dq": f"{FLASH_BWD_TPU}:511",
                   "fullint_dkv": f"{FLASH_BWD_TPU}:584"}
QSPLIT_DESIGN = (
    "phase 24's split-D frame over the payload (256 output lanes a CTA, the "
    "scores over the whole head dim in 32-lane chunks, recomputed once a "
    "slice): int8 / int4 rows read as they lie and dequantized (or kept as "
    "integers) a chunk at a time, the forward's whole rows (and the "
    "full-integer pair's int8 rows) landing as raw bytes through a 4-stage "
    "cp.async ring and widened in shared memory, V's slice raw under the "
    "scores, the forward's KV axis split where the grid leaves SMs idle "
    "(then split_d_fwd_merge_kernel), bf16 mma.sync for a bf16 Q, s8 mma.sync "
    "m16n8k32 for an int8 Q and the full-integer S and dP, P.V (dQ, dK, dV) "
    "over the CTA's slice on bf16 mma.sync, fp32 FMAs where the mode does "
    "not round to bf16 and at the full-integer level 2")
# (a)'s widths (580 runs at 592) and shape (B, Hq, Hkv, S, S): 16 causal
# q heads over one; (b)'s widths.
QSPLIT_DIMS = (580, 608, 640, 1024, 1152)
QSPLIT_SHAPE = (1, DS_HQ, 1, 200, 200)
QSPLIT_TIMED = (640, 1024)
# BLOCK_2D blocks whose cells straddle the 256-lane slices.
QSPLIT_STRADDLE = {608: 152, 640: 80, 1152: 48}


def check_quantized_split_d_all(rng):
    """(a) Every quantized kernel at each of QSPLIT_DIMS against its plain
    version (``check_quantized_width``; BLOCK_2D where 16-lane blocks tile
    the head dim: not at 580), BLOCK_2D blocks straddling the
    slices (forward and exact pair), sparse rows with an empty one (the
    forward), a level-2 span below one k step (S=144: 16 wide) and one
    forward at 2048, each twice, bit for bit → {label: errors}."""
    errs = {}
    row8c = qcfg(strategy="centered")
    for d in QSPLIT_DIMS:
        check_quantized_width(rng, d, QSPLIT_SHAPE, errs,
                              block2d=d % 16 == 0)
        if d in QSPLIT_STRADDLE:
            bs = QSPLIT_STRADDLE[d]
            b2d = qcfg(gran="block_2d", strategy="centered", block_rows=4,
                       block_size=bs)
            label = f"BLOCK_2D {bs} straddling the slices"
            errs[f"fwd d{d} {label}"] = check_qattn(
                rng, f"D={d} {label}", *QSPLIT_SHAPE, d, b2d, b2d,
                repeat=True)
            errs[f"qflash d{d} {label}"] = check_qflash(
                rng, f"D={d} {label}", *QSPLIT_SHAPE, d, b2d, b2d,
                repeat=True)
    seg = masking.build_segment_ranges(np.repeat(np.arange(4), 50))
    seg[77] = (10, 10)
    errs["fwd d640 sparse rows"] = check_qattn(
        rng, "D=640 sparse rows, an empty one", *QSPLIT_SHAPE, 640, row8c,
        row8c, mask=masking.MaskSpec(masking.MaskKind.SPARSE_RANGES),
        mask_ranges=seg, repeat=True)
    errs["fwd d2048 int8 ROW CENTERED"] = check_qattn(
        rng, "D=2048 int8 ROW CENTERED", 1, 2, 1, 64, 64, 2048, row8c, row8c,
        repeat=True)
    errs["fullint d640 w16 l2"] = check_fullint(
        rng, "D=640 ROW K / CHANNEL V, S=144", 1, 8, 1, 144, 640, qcfg(),
        qcfg(gran="channel"), True,
        BlockSizes(block_kv_dq=512, block_q_dkv=512), repeat=True)
    log(f"phase 25 (a): {len(errs)} checks, each bit for bit on a repeat")
    return errs


def time_quantized_perceiver(rng, split_d_perceiver):
    """(b) ``QuantizedAttention``'s forward (int8 ROW CENTERED K/V
    quantized at run time, FULL) at Perceiver IO's cross-attention
    (PERCEIVER), bf16: the whole call (events; the counts set to 0 just
    before one call and read after), the quantized forward alone on its
    K/V (events and device ms) beside its bound, its plain version (held
    to it at the flash gates), SDPA over the dequantized bf16 K/V and
    phase 24's float split-D forward on float K/V of the same shape."""
    b, h, sq, skv, d = PERCEIVER
    gen = device_generator(rng)
    q, k, v = (torch.randn((b, h, n, d), generator=gen, device=DEV).to(
        torch.bfloat16) for n in (sq, skv, skv))
    facade = QuantizedAttention()
    rtq.rtq_rows.launches = 0
    o_call, counts = split_launches(lambda: facade(q, k, v))
    counts["runtime_quantize_row"] = rtq.rtq_rows.launches
    splits = tfa.split_d_fwd_splits(d, b, h, sq, skv, sm_count())
    if splits < 2 or counts != {"runtime_quantize_row": 2, "qattn_fwd": 1,
                                "merge_fwd_splits": 1}:
        raise AssertionError(f"Perceiver facade: {splits} runs, launches "
                             f"{counts}")
    kq, vq = facade.quantize_kv(k, v)
    a, kw = qattn_arguments(q, kq, vq)
    kernel = lambda: qattn_fwd(*a, **kw)  # noqa: E731
    plain = lambda: qattn_fwd_plain(*a, **kw, kv_tile=KV_TILE)  # noqa: E731
    out = kernel()
    same_bits("Perceiver facade forward (split_d, its KV axis split)", out,
              kernel())
    errs = check_pair(f"Perceiver facade forward (split_d, {splits} runs)",
                      out, plain())
    if not torch.equal(o_call, out[0].to(o_call.dtype)):
        raise AssertionError("Perceiver facade: the call's O is not its "
                             "kernel's")
    del out
    kd, vd = dequantized_bf16(kq), dequantized_bf16(vq)
    t = {"facade_ms": time_ms(lambda: facade(q, k, v), 5, warmup=1),
         "ms": time_ms(kernel, 5, warmup=1),
         "plain_ms": time_ms(plain, 2, warmup=1),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             q, kd, vd), 10)}
    t["ms_2"] = time_ms(kernel, 5, warmup=0)
    t["device_ms_by_kernel"] = device_ms_by_label(kernel, 3)
    t["device_ms"] = (sum(t["device_ms_by_kernel"].values())
                      or measure_held(kernel, iters=3, warmup=0) * 1e3)
    t["facade_device_ms_by_kernel"] = device_ms_by_label(
        lambda: facade(q, k, v), 3)
    t["library_backend"] = sdpa_backend(q, kd, vd)
    pairs, n_q, n_kv = b * h * sq * skv, b * h * sq * d, b * h * skv * d
    t["bound_ms"], t["bound_by"] = attn_bound(
        pairs, 0, 4 * d, 2 * n_q + 2 * n_kv + 16 * b * h * skv + 4 * n_q
        + 4 * b * h * sq)
    t["float_split_d_ms"] = split_d_perceiver["ms"]
    t["float_split_d_device_ms"] = split_d_perceiver["device_ms"]
    t["launches"] = counts
    t["splits"] = splits
    t["rel_err"], t["max_abs_err"] = errs[0], errs[2]
    t["body"] = qattn_body(a[0].dtype, kw["mode"], d=d)
    t["shape"] = (f"B={b} H={h} Sq={sq} Skv={skv} D={d} FULL bf16, int8 "
                  "ROW CENTERED K/V (Perceiver IO image cross-attention)")
    parent_turns("qattn_fwd Perceiver IO facade (D=1024)", t, kernel, 5,
                 device=True)
    t["merge"] = check_fwd_merge("Perceiver facade forward", kernel, h)
    log("phase 25 (b) Perceiver IO facade forward: " + json.dumps(t))
    return t


def time_quantized_split_d(rng, split_d_times):
    """(b) The five kernels at D = 640 and 1024 on phase 24 (b)'s trio
    shape (B=2, Hq=16 over one head, S=2048; int8 ROW K/V, causal; the
    full-integer pair FULL over CHANNEL V, levels 1 and 2):
    ``time_wide_kernels``' events, device ms, bound, plain and SDPA, and
    phase 24's float split-D kernel at the same shape beside each."""
    out = {}
    for d in QSPLIT_TIMED:
        gen = device_generator(rng)
        b, hq, s = DS_TRAIN_BATCH, DS_HQ, DS_TRAIN_SEQ
        q, do = (torch.randn((b, hq, s, d), generator=gen, device=DEV).to(
            torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((b, 1, s, d), generator=gen, device=DEV)
                for _ in range(2))
        kq, vq, vq_ch = (quantize(k, qcfg()), quantize(v, qcfg()),
                         quantize(v, qcfg(gran="channel")))
        del k, v
        times = time_wide_kernels((q, kq, vq, vq_ch, do), scale=d ** -0.5,
                                  fam="split_d")
        flash = split_d_times[f"d{d}"]
        for name, fl in (("qattn_fwd_split_d", "flash_fwd"),
                         ("qattn_fwd_split_d_int8_q", "flash_fwd"),
                         ("qflash_dq_split_d", "flash_dq"),
                         ("qflash_dkv_split_d", "flash_dkv"),
                         (f"fullint_dq_d{d}", "flash_dq"),
                         (f"fullint_dkv_d{d}", "flash_dkv")):
            times[name]["float_split_d_ms"] = flash[fl]["ms"]
            times[name]["float_split_d_device_ms"] = flash[fl].get(
                "device_ms")
            if times[name]["body"] != "split_d":
                raise AssertionError(f"{name} at D={d} runs "
                                     f"{times[name]['body']}")
        # With --parent, the kernels whose int32 sums are exact (the
        # full-integer pair, whose S and dP share the s8 scores with the
        # forward's int8 Q) and the folded exact dQ keep the parent's bits.
        moved = [f"{name} {k}" for name, t in times.items()
                 for k, v in t.items()
                 if k.startswith("parent_bits_equal") and v is False
                 and name.startswith(("fullint", "qflash_dq"))]
        if moved:
            raise AssertionError(f"D={d}: {moved} moved from the parent's "
                                 "bits")
        # The exact pair's traces name the quantized kernels, not the float
        # ones whose body they share.
        for family in ("qflash_dq", "qflash_dkv"):
            seen = set(times[f"{family}_split_d"]["device_ms_by_kernel"])
            if seen and QSPLIT_KERNELS[family] not in seen:
                raise AssertionError(f"{family} at D={d}: traced "
                                     f"{sorted(seen)}")
        out[f"d{d}"] = times
        del q, do, kq, vq, vq_ch
        torch.cuda.empty_cache()
    return out


QSPLIT_COUNTED = (qattn_fwd, fbwd.qflash_dq, fbwd.qflash_dkv, fbwd.fullint_dq,
                  fbwd.fullint_dkv, fbwd.merge_dkv_splits)


def run_quantized_split_d_path(seed, rng):
    """(c) SPLIT_D_CFG (phase 24's head dim 640 model, its weights from
    the same seed): ``quantized_forward(..., quantize_kv=True)`` over W8A8
    weights against the fp32 forward on the dequantized weights (rel L2 ≤
    QFWD_LOGITS_TOL; the counts set to 0 just before and read after: one
    quantized forward a layer, on the split-D kernel), then
    ``quantized_flash_attention`` forward and backward at its layer shape
    (B=2, 8 q heads over 2, 2048 tokens, int8 ROW K/V) with ``bwd_fullint``
    off (causal) and on (FULL, CHANNEL V), through ``check_joint_calls``
    (counted; gradients ≤ 0.05 rel L2) → record."""
    cfg = SPLIT_D_CFG
    d = cfg.head_dim
    params = init_params(cfg, torch.Generator().manual_seed(seed + 24),
                         device=DEV)
    out = {}
    with torch.inference_mode():
        qparams = quantize_weights(params, W8_CFG)
        for f in QSPLIT_COUNTED:
            f.launches = 0
        err, launches = run_quantized_attention_forward(
            cfg, qparams, seed, False, QFWD_LOGITS_TOL,
            "split-D quantized_forward(quantize_kv=True)")
        out["model_launches"] = {f.__name__: f.launches
                                 for f in QSPLIT_COUNTED if f.launches}
        names = set(device_ms_by_label(lambda: quantized_forward(
            qparams, torch.zeros(QFWD_TOKENS, dtype=torch.long, device=DEV),
            cfg, quantize_kv=True, packed_d64=False), 1))
        del qparams
    del params
    body = qattn_body(torch.int8, QAttnMode("column", "token"), d=d)
    qattn_names = {n for n in names if "qattn" in n or "hpack" in n}
    if body != "split_d" or (names and qattn_names != {
            QSPLIT_KERNELS["qattn_fwd"]}):
        raise AssertionError(f"head dim {d} quantized forward: {body}, "
                             f"traced {sorted(names)}")
    out.update(logits_rel_l2=err, launches=launches, body=body,
               device_kernels=sorted(qattn_names) or "not traced")
    gen = device_generator(rng)
    b, hq, hkv, s = 2, cfg.num_heads, cfg.num_kv_heads, QFWD_TOKENS[1]
    q, do = (torch.randn((b, hq, s, d), generator=gen, device=DEV).to(
        torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=DEV)
            for _ in range(2))
    kq, vq, vq_ch = (quantize(k, qcfg()), quantize(v, qcfg()),
                     quantize(v, qcfg(gran="channel")))
    calls = {"seconds": {}, "launches": {}, "grads_rel_l2": {},
             "kernels": {}}
    check_joint_calls(f"split-D D={d} layer shape", ("exact", "fullint"), q,
                      k, v, kq, vq, vq_ch, do, calls, splits=(2, 2),
                      scale=d ** -0.5)
    out.update(calls)
    out["shape"] = (f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} bf16, int8 ROW "
                    "K/V (causal); bwd_fullint: FULL over CHANNEL V")
    log("phase 25 (c) head dim 640 quantized path: " + json.dumps(
        {k_: out[k_] for k_ in ("logits_rel_l2", "launches",
                                "model_launches", "device_kernels",
                                "grads_rel_l2", "shape")}))
    return out


def run_quantized_split_d(seed, split_d):
    """Phase 25 (a)-(c), inputs from a nineteenth generator (seed + 24);
    ``split_d``: phase 24's record (its float times beside (b)'s) →
    (record, phase seconds)."""
    rng = np.random.default_rng(seed + 24)
    out, phase = {}, {}
    t = time.perf_counter()
    with torch.no_grad():
        out["errors"] = check_quantized_split_d_all(rng)
    torch.cuda.empty_cache()
    phase["qsplit_d_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    with torch.no_grad():
        out["times"] = time_quantized_split_d(rng, split_d["times"])
        out["perceiver"] = time_quantized_perceiver(rng,
                                                    split_d["perceiver"])
    torch.cuda.empty_cache()
    phase["qsplit_d_times"] = time.perf_counter() - t
    t = time.perf_counter()
    out["path"] = run_quantized_split_d_path(seed, rng)
    torch.cuda.empty_cache()
    phase["qsplit_d_path"] = time.perf_counter() - t
    return out, phase


def qsplit_errors(errors, path_kernels, family):
    """[(rel err, max abs err)] of one family's checks in phase 25 (a) and
    (c)."""
    if family == "qattn_fwd":
        picked = [(e[0], e[2]) for k, e in errors.items()
                  if k.startswith("fwd ")]
        return picked + [(e["qattn_fwd"][0], e["qattn_fwd"][2])
                         for e in path_kernels.values()]
    prefix = "qflash " if family.startswith("qflash") else "fullint "
    outs = ("dq", "dbias") if family.endswith("_dq") else ("dk", "dv")
    return ([e[o] for k, e in errors.items() if k.startswith(prefix)
             for o in outs if o in e]
            + [e[family][o] for e in path_kernels.values() if family in e
               for o in outs if o in e[family]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=None, help=(
        "a checkout of the parent commit: its kernels are built too, and "
        "every timed kernel is also timed on them in turns (parent, "
        "change, change, parent)"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # A calibration store of this run's own: no plan stored on the machine
    # changes a launch in any phase, and phase 14 (c) writes here.
    os.environ["MFA_CACHE_DIR"] = tempfile.mkdtemp(prefix="mfa-tuning-")
    atexit.register(shutil.rmtree, os.environ["MFA_CACHE_DIR"], True)
    rng = np.random.default_rng(args.seed)
    phase_s = {}

    t = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"device: {smi}")
    build_all(args.parent)
    phase_s["build"] = time.perf_counter() - t

    t = time.perf_counter()
    err_dec = check_decode(rng, 64)
    err_dec128 = check_decode(rng, 128)
    err_pf = max(check_prefill(rng, off) for off in (0, 512, 300))
    paged_fp32_errs, paged_same = check_paged_fp32(args.seed)
    phase_s["kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    flash_train_errs, flash_small_worst = check_flash_all(rng)
    phase_s["flash_kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    cfg = TransformerConfig()  # the flagship: 8 x 1024, 16/4 heads, bf16
    gen = torch.Generator().manual_seed(args.seed)
    params = init_params(cfg, gen, device=DEV)
    with torch.inference_mode():
        check_logits(cfg, params, rng)
    phase_s["logits"] = time.perf_counter() - t

    t = time.perf_counter()
    launches, stats, prompt_lens, float_rates = run_engine(cfg, params,
                                                           args.seed)
    phase_s["engine"] = time.perf_counter() - t

    t = time.perf_counter()
    grad_worst = check_train_grads(cfg, params, rng)
    phase_s["grads"] = time.perf_counter() - t

    t = time.perf_counter()
    init_logits = quantized_logits_at_init(cfg, params, args.seed)
    phase_s["quant_logits_init"] = time.perf_counter() - t

    t = time.perf_counter()
    init_qfwd = run_quantized_attention_forwards(cfg, params, args.seed, None,
                                                 "random-init")
    phase_s["qattn_forward_init"] = time.perf_counter() - t

    t = time.perf_counter()
    train_init = clone_params(params)
    train_launches, train_tps = run_train(cfg, params, args.seed)
    phase_s["train"] = time.perf_counter() - t
    t = time.perf_counter()
    train_det = check_train_determinism(cfg, train_init, args.seed, params)
    del train_init
    phase_s["train_determinism"] = time.perf_counter() - t

    t = time.perf_counter()
    with torch.inference_mode():
        dec_lens = [n + 16 for n in prompt_lens]
        dec_t, dec_bound, dec_by = time_decode(rng, dec_lens)
        # The same decode at D=128 (the TPU's _decode_kernel schedule; off
        # the flagship's path, so it has no launches there).
        d128_t, d128_bound, _ = time_decode(rng, dec_lens, d=128)
        pf_t, pf_bound, pf_by = time_prefill(rng, 512)
    flash_t = time_flash(rng)
    phase_s["times"] = time.perf_counter() - t

    quant, quant_phase = run_quantized(
        cfg, params, args.seed, np.random.default_rng(args.seed + 1),
        dec_lens)
    phase_s.update(quant_phase)
    qattn, qattn_phase = run_quantized_attention(
        cfg, params, args.seed, np.random.default_rng(args.seed + 2))
    phase_s.update(qattn_phase)
    qbwd, qbwd_phase = run_quantized_backward(args.seed)
    phase_s.update(qbwd_phase)
    mla, mla_phase = run_mla(args.seed, dec_lens)
    phase_s.update(mla_phase)
    gemm, gemm_phase = run_gemm_engine(args.seed)
    phase_s.update(gemm_phase)
    disp, disp_phase = run_dispatch_layer(args.seed)
    phase_s.update(disp_phase)
    mla_train, mla_train_phase = run_mla_training(args.seed)
    phase_s.update(mla_train_phase)
    torch.cuda.empty_cache()  # the ranks of phase 16 share the card
    cp, cp_phase = run_context_parallel(args.seed)
    phase_s.update(cp_phase)
    util, util_phase = run_long_context_and_utilities(args.seed)
    phase_s.update(util_phase)
    torch.cuda.empty_cache()  # the ranks of phase 18 share the card
    spmd, spmd_phase = run_spmd(args.seed)
    phase_s.update(spmd_phase)
    torch.cuda.empty_cache()
    wide, wide_phase = run_wide_quantized(args.seed)
    phase_s.update(wide_phase)
    torch.cuda.empty_cache()
    deepseek, deepseek_phase = run_deepseek(args.seed, dec_lens)
    phase_s.update(deepseek_phase)
    torch.cuda.empty_cache()
    ds_train, ds_train_phase = run_deepseek_training(args.seed)
    phase_s.update(ds_train_phase)
    torch.cuda.empty_cache()
    latent_q, latent_q_phase = run_latent_quantized(args.seed)
    phase_s.update(latent_q_phase)
    torch.cuda.empty_cache()
    widths, widths_phase = run_width_faults(args.seed, dec_lens)
    phase_s.update(widths_phase)
    torch.cuda.empty_cache()
    split_d, split_d_phase = run_split_d(args.seed, dec_lens)
    phase_s.update(split_d_phase)
    torch.cuda.empty_cache()
    qsplit, qsplit_phase = run_quantized_split_d(args.seed, split_d)
    phase_s.update(qsplit_phase)
    log_parent_summary()
    log("phase seconds: " + json.dumps(
        {k: round(v, 2) for k, v in phase_s.items()}))
    engines = quant["engines"]
    log("engine rates, float / W8A8+int8 / W4A8+int4: " + json.dumps(
        {"float": float_rates, **{k: v["rates"] for k, v in engines.items()}}))
    log("MLA engine rates, float / W8A8+int8 latent: " + json.dumps(
        {k: v["rates"] for k, v in mla["engines"].items()}))
    log("V2-Lite engine rates, float / W8A8+int8 latent: " + json.dumps(
        {k: v["rates"] for k, v in deepseek["engines"].items()}))
    log("V2-Lite train: " + json.dumps({k: ds_train["train"][k] for k in (
        "ms_per_step", "tokens_per_s", "peak_memory_gib")}))

    record = {"kernels": [
        {"name": "paged_decode", "route": "cuda", "source": SOURCE,
         "replaces": f"{TPU_FILE}:209",
         "launches": launches["paged_decode"], "max_abs_err": err_dec,
         "max_abs_err_d128": err_dec128, "ms_d128": d128_t["ms"],
         "plain_ms_d128": d128_t["plain_ms"], "bound_ms_d128": d128_bound,
         "library_ms_d128": d128_t["library_ms"],
         "ms": dec_t["ms"], "plain_ms": dec_t["plain_ms"],
         "bound_ms": dec_bound, "bound_by": dec_by,
         "library_ms": dec_t["library_ms"],
         "replaces_also": f"{TPU_FILE}:65",
         "ms_covers": "the split kernel and " + PAGED_MERGE,
         "device_ms": dec_t["device_ms"],
         "device_ms_d128": d128_t["device_ms"],
         "library_device_ms": dec_t["library_device_ms"],
         "library_device_ms_d128": d128_t["library_device_ms"],
         "device_ms_by_kernel": dec_t["device_ms_by_kernel"],
         "device_kernel_merge": PAGED_MERGE,
         "device_kernel_fp32": "paged_decode_kernel",
         "bitwise_equal_two_calls": paged_same,
         "body": decode_body(torch.bfloat16, 64),
         "redesigned": PAGED_REDESIGNED["paged_decode"],
         **{f"parent_turns_{kind}{tag}": t[f"parent_turns_{kind}"]
            for tag, t in (("", dec_t), ("_d128", d128_t))
            for kind in ("ms", "device_ms") if f"parent_turns_{kind}" in t}},
        {"name": "paged_prefill", "route": "cuda", "source": SOURCE,
         "replaces": f"{TPU_FILE}:306",
         "launches": launches["paged_prefill"], "max_abs_err": err_pf,
         "ms": pf_t["ms"], "plain_ms": pf_t["plain_ms"],
         "bound_ms": pf_bound, "bound_by": pf_by,
         "library_ms": pf_t["library_ms"],
         "device_ms": pf_t["device_ms"],
         "library_device_ms": pf_t["library_device_ms"],
         "device_kernel_fp32": "paged_prefill_kernel",
         "body": prefill_body(torch.bfloat16, 64, 2, 0),
         "redesigned": PAGED_REDESIGNED["paged_prefill"],
         **{f"parent_turns_{kind}": pf_t[f"parent_turns_{kind}"]
            for kind in ("ms", "device_ms") if f"parent_turns_{kind}" in pf_t}},
    ]}
    for entry in record["kernels"]:
        kind = entry["name"].split("_")[1]
        entry["max_abs_err_fp32"] = {
            k.split(" ", 1)[1]: v for k, v in paged_fp32_errs.items()
            if k.startswith(kind)}
    # The paged kernels' int8 / int4 modes, from phase 9.
    for entry, kind in zip(record["kernels"], ("decode", "prefill")):
        for bits in (8, 4):
            qt = quant["times"][f"{kind}_int{bits}"]
            eng = engines[f"w{bits}a8+int{bits}"]["launches"]
            entry.update({
                f"launches_int{bits}": eng[f"paged_{kind}"],
                f"max_abs_err_int{bits}": quant["errors"][
                    f"{kind}_int{bits}"],
                **{f"{key}_int{bits}": qt[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "device_ms", "library_device_ms",
                    "parent_turns_ms", "parent_turns_device_ms")
                if key in qt},
            })
    g8, g8p, g8q = (quant["times"][f"dyn_gemm_w8_m{m}"]
                    for m in (8, 256, QFWD_M))
    g4, g4p, g4q = (quant["times"][f"dyn_gemm_w4_m{m}"]
                    for m in (8, 256, QFWD_M))
    record["kernels"].append({
        "name": "dyn_gemm", "route": "cuda", "source": GEMM_SOURCE,
        "replaces": f"{GEMM_TPU}:1002",
        "launches": sum(e["launches"]["dyn_gemm"] for e in engines.values()),
        **{f"launches_{k.split('+')[0]}": e["launches"]["dyn_gemm"]
           for k, e in engines.items()},
        "max_abs_err": quant["errors"]["dyn_gemm"],
        "shape": "one model call's 57 GEMMs at M=8 (decode), W8A8",
        "ms": g8["ms"], "plain_ms": g8["plain_ms"],
        "bound_ms": g8["bound_ms"], "bound_by": g8["bound_by"],
        "library_ms": g8["library_ms"],
        "library": "torch._int_mm on the same int8 operands (M padded to 32)",
        "library_bf16_matmul_ms": g8["library_bf16_matmul_ms"],
        "device_ms": g8["device_ms"],
        "library_device_ms": g8["library_device_ms"],
        "shape_m4096": f"the fully quantized forward's 57 GEMMs at "
                       f"M={QFWD_M}, the unembedding's too",
        **{f"{key}_{tag}": t[key] for tag, t in (
            ("m256", g8p), ("m4096", g8q), ("w4_m8", g4), ("w4_m256", g4p),
            ("w4_m4096", g4q))
           for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms", "library_bf16_matmul_ms", "device_ms",
                       "library_device_ms")},
        **{f"parent_turns_{kind}_{tag}": t[f"parent_turns_{kind}"]
           for tag, t in (("m8", g8), ("m256", g8p), ("m4096", g8q),
                          ("w4_m8", g4), ("w4_m256", g4p),
                          ("w4_m4096", g4q))
           for kind in ("ms", "device_ms") if f"parent_turns_{kind}" in t},
        "body": "tensor_core", "redesigned": REDESIGNED,
    })
    replaces = {"flash_fwd": f"{FLASH_TPU}:546",
                "flash_dq": f"{FLASH_BWD_TPU}:77",
                "flash_dkv": f"{FLASH_BWD_TPU}:954"}
    # The paged kernels at MLA's geometry, from phase 12.
    for entry, kind in zip(record["kernels"], ("decode", "prefill")):
        mt = mla["paged_times"][kind]
        errs_k = [e for n, e in mla["paged_errors"].items()
                  if n.startswith(kind)]
        entry.update({
            **{f"launches_mla_{k}": e["launches"][f"paged_{kind}"]
               for k, e in mla["engines"].items()},
            "rel_err_mla": max(e[0] for e in errs_k),
            "max_abs_err_mla": max(e[1] for e in errs_k),
            **{f"{key}_mla": mt[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "library_device_ms", "parent_turns_ms",
                "parent_turns_device_ms") if key in mt},
            "body_mla": (decode_body(torch.bfloat16, MLA_D)
                         if kind == "decode"
                         else prefill_body(torch.bfloat16, MLA_D, 1,
                                           MLA_VTZ)),
        })
    # The paged kernels at DeepSeek's absorbed width 576, from phase 20.
    for entry, kind in zip(record["kernels"], ("decode", "prefill")):
        dt = deepseek["paged_times"][kind]
        errs_k = {n: e for n, e in deepseek["paged_errors"].items()
                  if n.startswith(kind)}
        entry.update({
            **{f"launches_deepseek_{k}": e["launches"][f"paged_{kind}"]
               for k, e in deepseek["engines"].items()},
            "max_abs_err_deepseek": max(
                e for n, e in errs_k.items() if not n.endswith("f32")),
            "max_abs_err_deepseek_fp32": max(
                e for n, e in errs_k.items() if n.endswith("f32")),
            **{f"{key}_deepseek": dt[key] for key in (
                "ms", "ms_2", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms", "library_device_ms",
                "library_backend", "library_kernels") if key in dt},
            "library_deepseek": "sdpa over the gathered bf16 K/V "
                                "(enable_gqa; the backend torch took in "
                                "library_backend_deepseek)",
            "body_deepseek": (decode_body(torch.bfloat16, DS_D)
                              if kind == "decode"
                              else prefill_body(torch.bfloat16, DS_D, 1,
                                                DS_VTZ)),
            "device_kernel_deepseek": ("paged_decode_tc_kernel"
                                       if kind == "decode"
                                       else "paged_prefill_wide_kernel"),
            "bitwise_equal_two_calls_deepseek": True,  # (a) raises otherwise
            "shape_deepseek": "Hq=16 over the latent, D=576, one-state pages, "
                              "v_tail_zero=64 (DeepSeek-V2-Lite)",
        })
    next(e for e in record["kernels"] if e["name"] == "dyn_gemm").update({
        "launches_deepseek_w8a8": deepseek["engines"]["w8a8+int8"][
            "launches"]["dyn_gemm"],
        "bitwise_equal_shapes_deepseek": deepseek["dyn_gemm_cases"],
    })
    mla_flash = mla["flash_errors"]
    for name, t in flash_t.items():
        bf16 = flash_train_errs[torch.bfloat16]
        fp32 = flash_train_errs[torch.float32]
        keys = (("o", "l") if name == "flash_fwd" else
                ("dq",) if name == "flash_dq" else ("dk", "dv"))
        mt = mla["flash_times"][name]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": replaces[name], "launches": train_launches[name],
            "max_abs_err": max(bf16[k][1] for k in keys),
            "rel_err": max(bf16[k][0] for k in keys),
            "rel_err_fp32": max(fp32[k][0] for k in keys),
            "rel_err_small_shapes_worst": flash_small_worst,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": ("sdpa forward" if name == "flash_fwd" else
                        "sdpa backward (dq, dk, dv together)"),
            **{f"rel_err_mla_d{d}": max(
                errs[k][0] for label, errs in mla_flash.items()
                if label.startswith(f"d{d}") for k in keys)
               for d in (80, 288)},
            **{f"{key}_mla_d288": mt[key] for key in (
                "ms", "ms_2", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms", "device_ms_by_kernel",
                "parent_turns_ms", "parent_turns_device_ms",
                "parent_turns_device_ms_by_kernel") if key in mt},
            **({"body": t["body"], "body_mla_d288": mt["body"],
                "redesigned": REDESIGNED} if "body" in t else {}),
            **({"device_kernel_mla_d288": WIDE_KERNELS[name],
                "redesigned_mla_d288": WIDE_REDESIGNED[name],
                "bitwise_equal_two_calls_mla_d288": mla["flash_same_bits"][
                    name.split("_")[1]]} if name in WIDE_KERNELS else {}),
            **({"rel_err_mla_d288_row_max": {
                mode: max(e["o"][0], e["l"][0]) for mode, e in mla[
                    "flash_static_max_errors"].items()},
                "bitwise_equal_two_calls_mla_d288_row_max": mla[
                    "flash_same_bits"]["fwd_row_max"]}
               if name == "flash_fwd" else {}),
        })
    mt = mla["merge_times"]
    record["kernels"].append({
        "name": "flash_dkv_merge", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": f"{FLASH_BWD_TPU}:954",
        "replaces_note": "the second launch of _dkv_kernel's port at D = 288: "
                         "the split GQA group's partials summed in split "
                         "order (the TPU's sequential grid summed the "
                         "group in one kernel)",
        "launches": mla_train["launches_per_step"]["flash_dkv_merge"]
        * MLA_TRAIN_STEPS,
        "launches_mla_train_step_d288": mla_train["launches_per_step"][
            "flash_dkv_merge"],
        "max_abs_err": mt["max_abs_err"],
        **{k: mt[k] for k in ("ms", "ms_2", "plain_ms", "plain_ms_2",
                              "bound_ms", "bound_by", "library_ms",
                              "device_ms", "splits", "shape")},
        "library": "torch.sum over the splits",
    })
    # The flash kernels at DeepSeek's absorbed width 576, from phase 21: the
    # bf16 latent kernels (the fp32 instances' errors beside them).
    ds_errs, ds_step = ds_train["errors"], ds_train["train"][
        "launches_per_step"]
    for name, kernel in LATENT_KERNELS.items():
        outs = (("o", "l", "o_row_max", "l_row_max") if name == "flash_fwd"
                else ("dq", "dbias") if name == "flash_dq" else ("dk", "dv"))
        errs_by = {dt: [e[o] for case, e in ds_errs.items()
                        if case.endswith(dt) for o in outs if o in e]
                   for dt in ("bfloat16", "float32")}
        t = ds_train["times"][name]
        record["kernels"].append({
            "name": f"{name}_latent", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": replaces[name],
            "launches": ds_step[name] * DS_TRAIN_STEPS,
            "launches_v2_lite_train_step": ds_step[name],
            "launches_v2_lite_fp32_grads": ds_train["grad_launches"][name],
            "max_abs_err": max(e[1] for e in errs_by["bfloat16"]),
            "rel_err": max(e[0] for e in errs_by["bfloat16"]),
            "max_abs_err_fp32": max(e[1] for e in errs_by["float32"]),
            "rel_err_fp32": max(e[0] for e in errs_by["float32"]),
            **{key: t[key] for key in (
                "ms", "ms_2", "plain_ms", "plain_ms_2", "bound_ms",
                "bound_by", "library_ms", "device_ms", "device_ms_by_kernel",
                "body")},
            "device_ms_v2_lite_train_step": ds_train["train"][
                "step_profile"]["device_ms_by_kernel"].get(kernel, 0.0)
            / ds_step[name],
            "library": ("sdpa forward" if name == "flash_fwd" else
                        "sdpa backward (dq, dk, dv together)"),
            "library_backend": ds_train["library_backend"],
            "shape": "B=2 Hq=16 Hkv=1 S=2048 D=576 causal bf16 "
                     "(DeepSeek-V2-Lite's absorbed attention)",
            "checks": len(ds_errs),
            "bitwise_equal_two_calls": True,  # (a) raises otherwise
            "device_kernel_fp32": {"flash_fwd": "flash_fwd_kernel",
                                   "flash_dq": "flash_dq_kernel",
                                   "flash_dkv": "flash_dkv_kernel"}[name],
            "redesigned": LATENT_REDESIGNED[name],
        })
    mt576 = ds_train["merge_times"]
    merge_entry = next(e for e in record["kernels"]
                       if e["name"] == "flash_dkv_merge")
    merge_entry.update({
        "launches_v2_lite_train_step_d576": ds_step["flash_dkv_merge"],
        "launches_v2_lite_train_d576": ds_step["flash_dkv_merge"]
        * DS_TRAIN_STEPS,
        **{f"{k}_d576": mt576[k] for k in (
            "ms", "ms_2", "plain_ms", "plain_ms_2", "bound_ms", "bound_by",
            "library_ms", "device_ms", "splits", "shape", "max_abs_err")},
    })
    next(e for e in record["kernels"] if e["name"] == "flash_fwd")[
        "launches_mla_decompression"] = sum(
            d["launches"]["flash_fwd"] for d in mla["decompression"].values())
    qt, fwd = qattn["times"], qattn["forward"]
    flagship_modes = ("quantize_q_row", "dequant_row8c", "dequant_row4c",
                      "folded_tensor", "folded_row")
    small_worst = max(e[0] for n, e in qattn["qattn_errors"].items()
                      if n not in flagship_modes)
    qattn_entries = [
        ("qattn_fwd", QATTN_SOURCE, f"{QATTN_TPU}:87",
         fwd["unpacked"][1]["qattn_fwd"],
         max(qattn["qattn_errors"][m][2] for m in flagship_modes),
         {"rel_err": max(qattn["qattn_errors"][m][0]
                         for m in flagship_modes),
          "rel_err_small_shapes_worst": small_worst,
          "launches_facade": qattn["facade"]["int8"][1]["qattn_fwd"],
          "shape": "B=2 Hq=16 Hkv=4 S=2048 D=64 causal, quantize_q ROW "
                   "(the unpacked quantized_forward's mode)",
          "body": qt["qattn_fwd"]["body"],
          "redesigned": REDESIGNED}),
        ("hpack_fwd", QATTN_SOURCE, f"{QATTN_TPU}:654",
         fwd["packed"][1]["hpack_fwd"],
         max(e[2] for e in qattn["hpack_errors"].values()),
         {"rel_err": max(e[0] for e in qattn["hpack_errors"].values()),
          "shape": "packed [2, 8, 2048, 128], int8 CHANNEL, causal",
          "body": qt["hpack_fwd"]["body"],
          "redesigned": REDESIGNED}),
        ("runtime_quantize_row", RTQ_SOURCE, f"{RTQ_TPU}:79",
         qattn["facade"]["int8"][1]["runtime_quantize_row"], 0.0,
         {"shape": "[16384, 64] bf16 CENTERED (the facade's K/V rows)",
          "redesigned": RTQ_REDESIGNED["runtime_quantize_row"],
          "facade_call": qt["facade"]}),
        ("runtime_quantize_block", RTQ_SOURCE, f"{RTQ_TPU}:63",
         qattn["block_launches"], 0.0,
         {"shape": "[4096, 1024] bf16 CENTERED bs 64 with sums",
          "redesigned": RTQ_REDESIGNED["runtime_quantize_block"],
          "cluster": rtq.block_cluster(1024, 64),
          "cluster_bs128": rtq.block_cluster(1024, 128)}),
    ]
    for name, source, replaces, launches, err, extra in qattn_entries:
        t = qt[name]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            **({"library": "sdpa over the dequantized bf16 K/V"}
               if t["library_ms"] is not None else {}),
            **extra,
            **{k: v for k, v in t.items() if k.endswith("_facade_mode")
               or k.endswith("_bs128") or k.startswith("device_ms")
               or k.startswith("parent_turns")},
        })
    bt, ns, qat = qbwd["times"], qbwd["north_star"], qbwd["qat"]
    errs, ns_errs = qbwd["errors"], qbwd["north_star_errors"]
    next(e for e in record["kernels"] if e["name"] == "qattn_fwd").update({
        "launches_north_star": ns["launches"]["fullint"]["qattn_fwd"],
        "max_abs_err_north_star": ns_errs["qattn_fwd"][2],
        "rel_err_north_star": ns_errs["qattn_fwd"][0],
        "rel_err_l_north_star": ns_errs["qattn_fwd"][1],
        "rel_err_one_pass_north_star_not_gated": ns_errs[
            "qattn_fwd_one_pass"][0],
        **{f"{key}_north_star": bt["qattn_fwd"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "parent_turns_ms") if key in bt["qattn_fwd"]},
        "shape_north_star": "B=4 H=4 S=4096 D=256 FULL, int8 Q and int8 P, "
                            "ROW K / CHANNEL V (both arms of the north-star "
                            "fwd+bwd)",
        "launches_mla_quantized_latent": mla["absorbed_quantized"][
            "launches"],
        "rel_err_mla_quantized_latent": mla["absorbed_quantized"][
            "errors"]["kernel"][0],
        "max_abs_err_mla_quantized_latent": mla["absorbed_quantized"][
            "errors"]["kernel"][2],
        "shape_mla_quantized_latent": "B=2 Hq=16 Hkv=1 S=2048 D=256 causal, "
                                      "bf16 Q, ROW CENTERED int8 latent "
                                      "(mla_absorbed_attention)",
    })

    def worst(name, index):
        """The worst (rel, max abs) error of a kernel over phase 11 (a)."""
        outs = ("dq", "dbias") if name.endswith("_dq") else ("dk", "dv")
        return max(e[index] for check, es in errs.items()
                   if check.startswith("fullint") == name.startswith(
                       "fullint")
                   for out, e in es.items() if out in outs)

    bwd_entries = [
        ("qflash_dq", f"{FLASH_BWD_TPU}:77",
         ns["launches"]["exact"]["qflash_dq"], "qflash",
         "B=4 H=4 S=4096 D=256 FULL, folded ROW K / CHANNEL V (the exact "
         "arm of the north-star fwd+bwd)"),
        ("qflash_dkv", f"{FLASH_BWD_TPU}:954",
         ns["launches"]["exact"]["qflash_dkv"], "qflash",
         "B=4 H=4 S=4096 D=256 FULL, per-token K / channel V dequant"),
        ("fullint_dq", f"{FLASH_BWD_TPU}:511",
         ns["launches"]["fullint"]["fullint_dq"], "fullint",
         "B=4 H=4 S=4096 D=256 FULL, level 1, ROW K (the north-star)"),
        ("fullint_dkv", f"{FLASH_BWD_TPU}:584",
         ns["launches"]["fullint"]["fullint_dkv"], "fullint",
         "B=4 H=4 S=4096 D=256 FULL, level 1, ROW K (the north-star)"),
    ]
    for name, replaces, launches, prefix, shape in bwd_entries:
        t = bt[name]
        extra = ({"launches_qat": qat["launches"]["qat"][name],
                  "launches_facade": qat["launches"]["facade"][name]}
                 if prefix == "qflash" else {})
        record["kernels"].append({
            "name": name, "route": "cuda", "source": QBWD_SOURCE,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(e[1] for e in ns_errs[name].values()),
            "rel_err": max(e[0] for e in ns_errs[name].values()),
            "max_abs_err_all_modes_worst": worst(name, 1),
            "rel_err_all_modes_worst": worst(name, 0),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": "sdpa backward over the dequantized bf16 K/V (dq, dk,"
                       " dv together)",
            "shape": shape, **extra,
            **{k: v for k, v in t.items()
               if k.endswith(("_qat_mode", "_level2"))},
            **({"body": t["body"], "redesigned": REDESIGNED}
               if "body" in t else {}),
        })
    wo_modes = {"wo_folded_gemm": (f"{GEMM_TPU}:235", "int8 ROW (WEIGHT_CFG)"),
                "wo_gemm": (f"{GEMM_TPU}:196", "int8 BLOCK 128 CENTERED")}
    # gemm_bench's shapes, by record key: (label in 13 (c), mode).
    wo_bench = {"wo_folded_gemm": {"int8_row": ("wo_folded_gemm",
                                                "int8 ROW SYMMETRIC")},
                "wo_gemm": {"int8_block256": ("wo_gemm int8",
                                              "int8 BLOCK 256 SYMMETRIC"),
                            "int4_block256": ("wo_gemm int4",
                                              "int4 BLOCK 256 SYMMETRIC")}}
    wo_keys = ("ms", "device_ms", "ms_fp32_out", "plain_ms", "bound_ms",
               "bound_by", "library_ms", "body", "tile_rows", "k_splits",
               "rel_err", "max_abs_err", "parent_turns_ms")
    for name, (replaces, mode) in wo_modes.items():
        t = mla["wo_times"][name]
        errs_k = [e for n, e in mla["wo_errors"].items()
                  if n.startswith("folded") == (name == "wo_folded_gemm")]
        entry = {
            "name": name, "route": "cuda", "source": GEMM_SOURCE,
            "replaces": replaces,
            "launches": sum(d["launches"][name]
                            for d in mla["decompression"].values()),
            "launches_matmul_paths": sum(c["launches"][name]
                                         for c in gemm["matmul"].values()),
            "max_abs_err": max(e[1] for e in errs_k),
            "rel_err": max(e[0] for e in errs_k),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": WO_LIBRARY,
            "device_ms": t["device_ms"], "ms_fp32_out": t["ms_fp32_out"],
            "body": t["body"],
            "tile_rows": t["tile_rows"], "k_splits": t["k_splits"],
            "body_fp32_a": wo_gemm_body(torch.float32),
            "redesigned": REDESIGNED,
            "shape": f"M={DEC_B * DEC_S} N={DEC_H * DEC_DH} K={DEC_DC}, bf16 "
                     f"latent, {mode}, bf16 out (mla_decompress)",
            **({"parent_turns_ms": t["parent_turns_ms"]}
               if "parent_turns_ms" in t else {}),
        }
        for tag, (label, bench_mode) in wo_bench[name].items():
            for m, n, k in GEMM_SHAPES:
                bt_ = gemm["times"][label][f"m{m}"]
                entry[f"shape_{tag}_m{m}"] = (
                    f"M={m} N={n} K={k}, bf16 A, {bench_mode}, bf16 out "
                    "(benchmarks/gemm_bench.py)")
                entry.update({f"{key}_{tag}_m{m}": bt_[key]
                              for key in wo_keys if key in bt_})
        record["kernels"].append(entry)
    gemm_tpu = {"qa_folded_gemm": 498, "qa_gemm": 461, "comp_gemm": 707,
                "comp_small_gemm": 763}
    gemm_shape = {
        "qa_folded_gemm": "int8 ROW SYMMETRIC A x bf16 B",
        "qa_gemm": "int8 ROW ASYMMETRIC A x bf16 B",
        "comp_gemm": "int8 x int8 BLOCK 512 SYMMETRIC",
        "comp_small_gemm": "int8 x int8 BLOCK 64 CENTERED"}
    for name, line in gemm_tpu.items():
        t = gemm["times"][name]
        errs_k = [e for label, e in gemm["kernel_errors"].items()
                  if label.startswith(
                      "qa folded" if name == "qa_folded_gemm" else
                      "qa int8" if name == "qa_gemm" else
                      "comp BLOCK" if name == "comp_gemm" else "comp-small")]
        big, small = t[f"m{GEMM_SHAPES[1][0]}"], t[f"m{GEMM_SHAPES[0][0]}"]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": GEMM_SOURCE,
            "replaces": f"{GEMM_TPU}:{line}",
            "launches": sum(c["launches"][name]
                            for c in gemm["matmul"].values()),
            "max_abs_err": max(e[1] for e in errs_k),
            "rel_err": max(e[0] for e in errs_k),
            **{key: big[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "library": GEMM_LIBRARY[name],
            "shape": "M=%d N=%d K=%d, %s" % (*GEMM_SHAPES[1],
                                             gemm_shape[name]),
            **({"call_ms": big["call_ms"]} if "call_ms" in big else {}),
            **{f"{key}_m{GEMM_SHAPES[0][0]}": small[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "call_ms", "parent_turns_ms", "parent_turns_device_ms")
               if key in small},
            **({"parent_turns_ms": big["parent_turns_ms"]}
               if "parent_turns_ms" in big else {}),
            **{f"device_ms{tag}": tt["device_ms"] for tag, tt in (
                ("", big), (f"_m{GEMM_SHAPES[0][0]}", small))},
            **({"parent_turns_device_ms": big["parent_turns_device_ms"]}
               if "parent_turns_device_ms" in big else {}),
            "body": (qa_gemm_body(torch.bfloat16) if name.startswith("qa")
                     else comp_small_body(64) if name == "comp_small_gemm"
                     else "tensor_core"),
            "redesigned": REDESIGNED,
            **({"device_kernel_scalar_route": COMP_SMALL_SCALAR}
               if name == "comp_small_gemm" else {}),
        })
    dt, serr = disp["times"], disp["static_errors"]
    path_errs = [e for c, e in serr.items() if c.startswith("path")]
    record["kernels"].append({
        "name": "flash_fwd_static_max", "route": "cuda",
        "source": FLASH_SOURCE, "replaces": f"{FLASH_TPU}:546",
        "launches": disp["static_launches"],
        "max_abs_err": max(e["o"][1] for e in path_errs),
        "rel_err": max(e["o"][0] for e in path_errs),
        "rel_err_l": max(e["l"][0] for e in path_errs),
        "rel_err_small_shapes_worst": max(
            max(e["o"][0], e["l"][0]) for c, e in serr.items()
            if not c.startswith("path")),
        "gap_to_running_max_worst": max(e["gap_running_max"]
                                        for e in serr.values()),
        "shape": "B=4 Hq=16 Hkv=4 S=2048 D=64 causal bf16, row_max "
                 "'estimate' (flash_attention_forward's static-max mode)",
        **{key: dt[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "library_device_ms", "running_max_ms",
            "running_max_device_ms", "estimate_ms", "estimate_device_ms",
            "ms_2", "device_ms_2", "running_max_device_ms_2",
            "library_device_ms_2")},
        "library": "sdpa forward",
        **({"parent_turns_running_max_ms": dt["parent_turns_ms"],
            "parent_turns_running_max_device_ms":
                dt["parent_turns_device_ms"]}
           if "parent_turns_ms" in dt else {}),
        "body": dt["body"],
    })
    mha = disp["multi_head"]
    for entry in record["kernels"]:
        if entry["name"] in ("flash_fwd", "flash_dq", "flash_dkv"):
            entry["launches_multi_head"] = {
                call: mha["path"][call][entry["name"]]
                for call in ("forward", "call_grad", "backward")}
    cp_cases = [c for c, v in cp.items() if isinstance(v, dict)]
    for i, name in enumerate(("flash_fwd", "flash_dq", "flash_dkv")):
        entry = next(e for e in record["kernels"] if e["name"] == name)
        per_step = mla_train["launches_per_step"][name]
        if mla_train["step_turns"] is not None:
            entry["parent_turns_mla_train_step_ms"] = mla_train[
                "step_turns"]["ms"]
        entry.update({
            "launches_mla_train_step_d288": per_step,
            "launches_mla_train_d288": per_step * MLA_TRAIN_STEPS,
            "launches_context_parallel_per_rank": {
                c: [r[i] for r in cp[c]["launches_per_rank"]]
                for c in cp_cases},
            "launches_spmd_train_step_per_rank": [
                [c[name] for c in r]
                for r in spmd["train"]["launches_per_step_per_rank"]],
        })
    next(e for e in record["kernels"] if e["name"] == "qattn_fwd")[
        "launches_long_context"] = util["long_context"]["launches"]
    wt, wp = wide["times"], wide["path"]
    prefix = {"qattn_fwd": "fwd ", "qflash_dq": "qflash ",
              "qflash_dkv": "qflash ", "fullint_dq": "fullint ",
              "fullint_dkv": "fullint "}
    for name, (family, _, replaces, source) in WIDE_QKERNELS.items():
        outs = (("o",) if family == "qattn_fwd" else
                ("dq", "dbias") if family.endswith("_dq") else ("dk", "dv"))
        # (a)'s checks of this kernel (its bf16 instances: fp32 takes the
        # scalar bodies) and (b)'s on the calls' own inputs.
        checks = [e for key, e in wide["errors"].items()
                  if key.startswith(prefix[family]) and "fp32" not in key]
        if family == "qattn_fwd":
            errs_a = [(e[0], e[2]) for e in checks]
            errs_b = [(e[family][0], e[family][2])
                      for e in wp["kernels"].values()]
        else:
            errs_a = [e[o] for e in checks for o in outs if o in e]
            errs_b = [e[family][o] for e in wp["kernels"].values()
                      if family in e for o in outs if o in e[family]]
        t = wt[name]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(c.get(family, 0)
                            for c in wp["launches"].values()),
            "launches_per_call": {k: c.get(family, 0)
                                  for k, c in wp["launches"].items()},
            "max_abs_err": max(e[1] for e in errs_a + errs_b),
            "rel_err": max(e[0] for e in errs_a + errs_b),
            "rel_err_mla_path": max(e[0] for e in errs_b),
            **{k: t[k] for k in ("ms", "ms_2", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms", "device_ms",
                                 "device_ms_by_kernel", "body")},
            "library": ("sdpa forward over the dequantized bf16 K/V"
                        if family == "qattn_fwd" else "sdpa backward over "
                        "the dequantized bf16 K/V (dq, dk, dv together)"),
            **{k: v for k, v in t.items() if k.endswith(("_level2", "splits"))
               or k == "width"},
            **({f"{k}_int8_q": v
                for k, v in wt["qattn_fwd_wide_int8_q"].items()
                if k in ("ms", "device_ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "body")}
               if family == "qattn_fwd" else {}),
            "shape": "B=2 Hq=16 Hkv=1 S=2048 D=288 (MLAConfig() layer 0's "
                     "joint latent), "
                     + ("causal, folded ROW K / ROW V"
                        if family.startswith(("qattn", "qflash")) else
                        "FULL, ROW K / CHANNEL V, level 1"),
            "bitwise_equal_two_calls": True,  # (a) raises otherwise
            "device_kernel_name_in_trace": wp["device_kernels"][
                WIDE_QKERNELS[name][1]],
            "redesigned": WIDE_QREDESIGNED[name],
        })
    # Phase 22's kernels at 576, as `*_d576` keys of the kernel's entry.
    lt, lp = latent_q["times"], latent_q["path"]
    for family, kernel in LATENT_QKERNELS.items():
        outs = (("o",) if family == "qattn_fwd" else
                ("dq", "dbias") if family.endswith("_dq") else ("dk", "dv"))
        checks = [e for key, e in latent_q["errors"].items()
                  if key.startswith(prefix[family]) and "fp32" not in key]
        if family == "qattn_fwd":
            errs_a = [(e[0], e[2]) for e in checks]
            errs_b = [(e[family][0], e[family][2])
                      for e in lp["kernels"].values()]
        else:
            errs_a = [e[o] for e in checks for o in outs if o in e]
            errs_b = [e[family][o] for e in lp["kernels"].values()
                      for o in outs if o in e[family]]
        t = lt[f"{family}_latent"]
        next(e for e in record["kernels"] if e["name"] == family).update({
            "launches_d576": sum(c.get(family, 0)
                                 for c in lp["launches"].values()),
            "launches_per_call_d576": {k: c.get(family, 0)
                                       for k, c in lp["launches"].items()},
            "max_abs_err_d576": max(e[1] for e in errs_a + errs_b),
            "rel_err_d576": max(e[0] for e in errs_a + errs_b),
            "rel_err_v2_lite_path_d576": max(e[0] for e in errs_b),
            **{f"{k}_d576": t[k] for k in (
                "ms", "ms_2", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms", "device_ms_by_kernel", "body")},
            **({"splits_d576": t["splits"]} if "splits" in t else {}),
            **({f"{k}_int8_q_d576": v
                for k, v in lt["qattn_fwd_latent_int8_q"].items()
                if k in ("ms", "device_ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "body")}
               if family == "qattn_fwd" else {}),
            "library_d576": ("sdpa forward" if family == "qattn_fwd" else
                             "sdpa backward (dq, dk, dv together)")
                            + " over the dequantized bf16 K/V (MATH at 576)",
            "shape_d576": "B=2 Hq=16 Hkv=1 S=2048 D=576 (V2_LITE layer 0's "
                          "joint latent), causal, folded ROW K / ROW V",
            "bitwise_equal_two_calls_d576": True,  # (a) raises otherwise
            "device_kernel_d576": kernel,
            "device_kernel_name_in_trace_d576": lp["device_kernels"][kernel],
            "redesigned_d576": LATENT_QREDESIGNED[family],
        })
    # Phase 23: the full-integer pair at 576, entries of their own; the
    # flash, quantized and paged kernels at 40 and 72 as `*_<shape>` keys.
    wf, werrs = widths["fullint"], widths["errors"]
    for family, (kernel, scalar, replaces) in FULLINT_576.items():
        t = wf["times"][f"{family}_d{DS_D}"]
        outs = ("dq",) if family == "fullint_dq" else ("dk", "dv")
        errs_ab = ([e[o] for key, e in werrs.items()
                    if key.startswith(f"fullint d{DS_D}") for o in outs]
                   + [e[family][o] for e in wf["kernels"].values()
                      for o in outs])
        record["kernels"].append({
            "name": f"{family}_d{DS_D}", "route": "cuda",
            "source": QBWD_SOURCE, "replaces": replaces,
            "launches": sum(c.get(family, 0)
                            for c in wf["launches"].values()),
            "launches_per_call": {k: c.get(family, 0)
                                  for k, c in wf["launches"].items()},
            "max_abs_err": max(e[1] for e in errs_ab),
            "rel_err": max(e[0] for e in errs_ab),
            **{k: t[k] for k in ("ms", "ms_2", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms", "device_ms",
                                 "device_ms_by_kernel", "body", "width")},
            **{k: v for k, v in t.items()
               if k.endswith("_level2") or k == "splits"},
            "library": "sdpa backward over the dequantized bf16 K/V (dq, "
                       "dk, dv together; MATH at 576)",
            "shape": wf["shape"] + " (levels 1 and 2)",
            "grads_rel_l2_vs_dense": wf["grads_rel_l2"],
            "bitwise_equal_two_calls": True,  # (c) raises otherwise
            "device_kernel_name_in_trace": wf["device_kernels"][kernel],
            "device_kernel_below_one_k_step": scalar,
            "redesigned": FULLINT_576_REDESIGNED[family],
        })
    for label, key in (("sd15_unet_level1", "sd15"), ("dit_xl2_512px", "dit")):
        pub = widths["public"][label]
        for name, t in pub["times"].items():
            next(e for e in record["kernels"] if e["name"] == name).update({
                **{f"{k}_{key}": t[k] for k in (
                    "ms", "ms_2", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "device_ms", "library_device_ms", "width",
                    "body")},
                f"launches_{key}": pub["launches_bfloat16"][name],
                f"shape_{key}": pub["shape"],
                f"rel_err_{key}": pub["rel_err_bf16_vs_plain"],
                f"grad_rel_l2_fp32_{key}": pub["grad_rel_l2_fp32_vs_dense"],
                f"library_{key}": "sdpa on the same bf16 inputs"})
        d = int(pub["shape"].split("D=")[1].split()[0])
        for family in ("qattn_fwd", "qflash_dq", "qflash_dkv"):
            t = pub["quantized_times"][f"{family}_d{d}"]
            next(e for e in record["kernels"] if e["name"] == family).update(
                {f"{k}_{key}": t[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "device_ms", "body") if k in t})
    for entry, kind in zip(record["kernels"], ("decode", "prefill")):
        for dk, pt_ in widths["paged_times"].items():
            t, bound, by = pt_[kind]
            entry.update({f"{k}_{dk}": t[k] for k in (
                "ms", "plain_ms", "library_ms", "device_ms",
                "library_device_ms") if k in t})
            entry.update({f"bound_ms_{dk}": bound, f"bound_by_{dk}": by})
        entry["max_abs_err_off_grid"] = max(
            e for k, e in werrs.items() if k.startswith(f"paged {kind}"))
    # The split-D kernels above 576, from phase 24: times at D = 1024 (640
    # beside them), launches from (c)'s path.
    sd_path = split_d["path"]
    for name, kernel in SPLIT_D_KERNELS.items():
        paged = name.startswith("paged")
        kind = name.split("_")[1]
        errs_k = split_d_errors(split_d["errors"], name)
        times = {d: split_d["times"][d][kind if paged else name]
                 for d in ("d640", "d1024")}
        entry = {
            "name": f"{name}_split_d", "route": "cuda",
            "source": SPLIT_D_SOURCE, "replaces": SPLIT_D_REPLACES[name],
            "launches": (sd_path["serve_launches"][name] if paged
                         else sd_path["train_launches"][name]),
            "max_abs_err": max(e for _, e in errs_k),
            "max_abs_err_fp32": max(e for label, e in errs_k
                                    if "f32" in label or "float32" in label),
            **{key: times["d1024"][key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **{f"{key}_d640": times["d640"][key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms")},
            "device_ms": times["d1024"].get("device_ms"),
            "library": ("sdpa over the gathered bf16 K/V" if paged else
                        "sdpa forward" if name == "flash_fwd" else
                        "sdpa backward (dq, dk, dv together)"),
            "library_backend": times["d1024"].get(
                "library_backend",
                split_d["times"]["d1024"]["library_backend"]),
            "shape": ("Hq=16 over one head, latent pages, v_tail_zero=64, "
                      "D=1024" if paged else "B=2 Hq=16 Hkv=1 S=2048 "
                      "causal bf16, D=1024"),
            "checks": len(errs_k), "bitwise_equal_two_calls": True,
            "body": "split_d", "design": SPLIT_D_DESIGN,
            "launches_on": ("phase 24 (c): 8 requests served at head dim "
                            "640" if paged else "phase 24 (c): 4 train "
                            "steps at head dim 640"),
        }
        if name == "flash_fwd":
            entry.update({f"{k}_perceiver": split_d["perceiver"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "library_backend", "shape", "splits",
                "launches", "max_abs_err")})
            entry["splits"] = times["d1024"]["splits"]
            entry["splits_d640"] = times["d640"]["splits"]
        if name == "flash_dkv":
            entry["splits"] = split_d["times"]["d1024"]["splits"]
            entry["splits_d640"] = split_d["times"]["d640"]["splits"]
        DEVICE_KERNELS[entry["name"]] = kernel
        record["kernels"].append(entry)
    # The quantized kernels above 576, from phase 25: times at D = 1024
    # (640 beside them), launches from (c)'s path.
    qp = qsplit["path"]
    for family, kernel in QSPLIT_KERNELS.items():
        errs_k = qsplit_errors(qsplit["errors"], qp["kernels"], family)
        times = {d: qsplit["times"][f"d{d}"][
            f"{family}_d{d}" if family.startswith("fullint")
            else f"{family}_split_d"] for d in QSPLIT_TIMED}
        t, t640 = times[1024], times[640]
        per_call = {"model": qp["model_launches"].get(family, 0),
                    **{k: c.get(family, 0)
                       for k, c in qp["launches"].items()}}
        entry = {
            "name": f"{family}_split_d", "route": "cuda",
            "source": QSPLIT_SOURCES[family],
            "replaces": QSPLIT_REPLACES[family],
            "launches": sum(per_call.values()),
            "launches_per_call": per_call,
            "max_abs_err": max(e[1] for e in errs_k),
            "rel_err": max(e[0] for e in errs_k),
            **{k: t[k] for k in ("ms", "ms_2", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms", "device_ms",
                                 "device_ms_by_kernel", "body",
                                 "float_split_d_ms",
                                 "float_split_d_device_ms")},
            **{f"{k}_d640": t640[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "float_split_d_ms", "float_split_d_device_ms")},
            **{k: v for k, v in t.items()
               if k.endswith("_level2") or k in ("splits", "width")},
            **{f"{k}_d640": v for k, v in t640.items()
               if k.endswith("_level2") or k == "splits"},
            "library": ("sdpa forward" if family == "qattn_fwd" else
                        "sdpa backward (dq, dk, dv together)")
                       + " over the dequantized bf16 K/V",
            "shape": ("B=2 Hq=16 Hkv=1 S=2048 bf16, int8 ROW K/V, "
                      + ("FULL over CHANNEL V, levels 1 and 2"
                         if family.startswith("fullint") else "causal")
                      + ", D=1024"),
            "checks": len(errs_k), "bitwise_equal_two_calls": True,
            "design": QSPLIT_DESIGN,
            "launches_on": "phase 25 (c): the head dim 640 model's "
                           "quantized_forward(quantize_kv=True) and one "
                           "quantized_flash_attention fwd+bwd at its layer "
                           "shape with bwd_fullint off and on",
        }
        if family == "qattn_fwd":
            qt = qsplit["times"]["d1024"]["qattn_fwd_split_d_int8_q"]
            entry.update({f"{k}_int8_q": qt[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "body")})
            entry.update({f"{k}_perceiver": qsplit["perceiver"][k]
                          for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "device_ms", "facade_ms",
                                    "float_split_d_ms", "library_backend",
                                    "shape", "splits", "launches",
                                    "max_abs_err")})
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']}: no launch on the path")
        DEVICE_KERNELS[entry["name"]] = kernel
        record["kernels"].append(entry)
    # The split-D forward's merge, from phases 24 (b) and 25 (b): launched
    # by Perceiver IO's float and facade forwards (one each).
    fm, qfm = split_d["perceiver"]["merge"], qsplit["perceiver"]["merge"]
    entry = {
        "name": "split_d_fwd_merge", "route": "cuda",
        "source": SPLIT_D_SOURCE, "replaces": SPLIT_D_REPLACES["flash_fwd"],
        "replaces_note": "the second launch of _fwd_kernel's and "
                         "_qfwd_kernel's ports above 576 where the KV axis "
                         "splits: the runs' partials merged in split order "
                         "(the TPU's sequential grid walked the whole KV "
                         "axis in one kernel)",
        "launches": (split_d["perceiver"]["launches"]["merge_fwd_splits"]
                     + qsplit["perceiver"]["launches"]["merge_fwd_splits"]),
        "max_abs_err": max(fm["max_abs_err"], qfm["max_abs_err"]),
        **{k: fm[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "library", "device_ms",
                              "splits")},
        **{f"{k}_facade": qfm[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "device_ms", "max_abs_err")},
        "shape": (f"Perceiver IO's 512 rows of D=1024, {fm['splits']} "
                  "runs (the float forward's; the facade's beside it)"),
        "bitwise_equal_two_calls": True,
        "launches_on": "phases 24 (b) and 25 (b): one Perceiver IO float "
                       "forward and one facade call",
    }
    DEVICE_KERNELS[entry["name"]] = FWD_MERGE_KERNEL
    record["kernels"].append(entry)
    for entry in record["kernels"]:
        entry["device_kernel"] = DEVICE_KERNELS[entry["name"]]
    record["gemm_engine"] = {
        "matmul_rel_l2": {k: v["rel_l2"] for k, v in gemm["matmul"].items()},
    }
    record["mla"] = {
        "logits_rel_l2": mla["logits_rel_l2"],
        "decompression_rel_l2": {k: v["rel_l2"]
                                 for k, v in mla["decompression"].items()},
        "decompression_path_times": {
            k: v["times"] for k, v in mla["decompression"].items()},
        "absorbed_int8_latent_rel_l2": mla["absorbed_quantized"]["errors"][
            "vs_fp32_rel_l2"],
        "int8_p_span_rel_err": {k: v[0]
                                for k, v in mla["int8_p_errors"].items()},
        "rates": {k: v["rates"] for k, v in mla["engines"].items()},
    }
    record["quantized_backward"] = {
        key: ns[key] for key in ("fullint_vs_exact", "exact_vs_dense",
                                 "fullint_vs_dense_not_gated", "seconds")}
    record["quantized_backward"].update(qat_rel_l2=qat["qat"],
                                        facade_dq_rel_l2=qat["facade"])
    record["quantized_attention"] = {
        "logits_rel_l2": {k: v[0] for k, v in fwd.items()},
        "logits_rel_l2_random_init_not_gated": {
            k: v[0] for k, v in init_qfwd.items()},
        "facade_rel_l2": {k: v[0] for k, v in qattn["facade"].items()},
    }
    record["dispatch_layer"] = {
        "multi_head_launches": mha,
        "calibration": disp["calibration"],
        "quantized_attention_benchmark": disp["benchmark"],
    }
    record["mla_train"] = {
        key: mla_train[key] for key in (
            "ms_per_step", "tokens_per_s", "launches_per_step", "losses",
            "host_ms_per_step", "step_profile", "grad_rel_l2_worst",
            "determinism", "checkpoint", "step_turns")}
    record["deepseek_v2_lite"] = {
        "config": dataclasses.asdict(V2_LITE) | {"dtype": str(V2_LITE.dtype)},
        "reduced": ["26 MoE layers as dense SwiGLU at d_ff 10944",
                    "no YaRN RoPE scaling", "random weights from the seed"],
        "logits_rel_l2": deepseek["logits_rel_l2"],
        "paged_checks": len(deepseek["paged_errors"]),
        "paged_bodies": deepseek["paged_bodies"],
        "rates": {k: v["rates"] for k, v in deepseek["engines"].items()},
        "device_time": {k: v["device_time"]
                        for k, v in deepseek["engines"].items()},
        "train": {
            "reduced": ["26 MoE layers as dense SwiGLU at d_ff 10944",
                        "no YaRN RoPE scaling",
                        "random weights from the seed",
                        "8 steps on one seeded batch of 2 x 2049 tokens"],
            "fp32_grad_rel_l2_worst": ds_train["grad_rel_l2_worst"],
            "latent_kernel_checks": len(ds_errs),
            **ds_train["train"]},
    }
    record["context_parallel"] = {
        "world": CP_WORLD, "transport": "gloo through host memory, every "
        "rank on cuda:0", **cp}
    record["utilities"] = util
    record["latent_quantized"] = {
        "checks": len(latent_q["errors"]),
        "bitwise_equal_two_calls": True,  # (a) raises otherwise
        **{k: lp[k] for k in ("launches", "grads_rel_l2", "seconds",
                              "device_kernels", "shape")},
        "call_o_vs_plain": {k: e["call_o"] for k, e in lp["kernels"].items()},
        "long_context": latent_q["long_context"],
    }
    record["width_faults"] = {
        "checks": len(werrs), "off_grid_dims": list(OFF_GRID_DIMS),
        "bitwise_equal_two_calls": True,  # (a) raises otherwise
        "public": {k: {f: v[f] for f in ("shape", "width",
                                         "launches_bfloat16",
                                         "rel_err_bf16_vs_plain",
                                         "grad_rel_l2_fp32_vs_dense")}
                   for k, v in widths["public"].items()},
        "fullint_576": {k: wf[k] for k in ("launches", "grads_rel_l2",
                                           "seconds", "splits", "shape")},
    }
    record["split_d"] = {
        "checks": len(split_d["errors"]),
        "bitwise_equal_two_calls": True,  # (a) raises otherwise
        "launches": split_d["launches"],
        "path": {k: sd_path[k] for k in (
            "config", "reduced", "bodies", "logits_rel_l2", "serve_launches",
            "serve_rates", "serve_calls", "grad_rel_l2_worst",
            "train_launches", "train_losses", "train_s",
            "rerun_bitwise_equal")},
    }
    record["quantized_split_d"] = {
        "checks": len(qsplit["errors"]),
        "bitwise_equal_two_calls": True,  # (a) raises otherwise
        "path": {k: qp[k] for k in (
            "logits_rel_l2", "launches", "model_launches", "body",
            "device_kernels", "grads_rel_l2", "seconds", "shape")},
        "perceiver_launches": qsplit["perceiver"]["launches"],
    }
    record["wide_quantized"] = {
        "checks": len(wide["errors"]),
        "bitwise_equal_two_calls": True,  # (a) raises otherwise
        **{k: wp[k] for k in ("launches", "grads_rel_l2", "seconds",
                              "device_kernels", "shape")},
        "call_o_vs_plain": {k: e["call_o"] for k, e in wp["kernels"].items()},
        "long_context": wide["long_context"],
    }
    record["spmd"] = {
        "world": SPMD.world, "mesh_data_model_context": SPMD.mesh,
        "transport": "gloo through host memory, every rank on cuda:0",
        **{k: spmd[k] for k in ("grads", "train", "small", "moe_pipeline",
                                "dryrun_lines", "part_seconds_per_rank")}}
    record["train"] = {"tokens_per_s": train_tps,
                       "grad_rel_l2_worst": grad_worst,
                       "determinism": train_det}
    record["quantized_serving"] = {
        "logits_rel_l2": quant["logits_rel_l2"],
        "logits_rel_l2_random_init_not_gated": init_logits,
        "rates": {"float": float_rates,
                  **{k: v["rates"] for k, v in engines.items()}},
    }
    log(smi)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
