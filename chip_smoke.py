"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. Card identity (``nvidia-smi`` name and power limit), then the build of
   every kernel source with nvcc (all at once), with its time and ptxas's
   registers and spills for each kernel, and the bf16 dkv's dynamic shared
   memory; a ptxas note that it serialised a kernel's ``wgmma``s (C7520)
   fails the run.
2. The forward kernel against its plain PyTorch version on the card, in the
   listed cases, by ``forward_agreement`` (o by relative L2 error over the
   whole tensor, its late half and per row; o and lse by their largest
   absolute error); kernel, plain-version and library
   (``scaled_dot_product_attention``, timed only) times at the generate
   prefill's shape, at the training shape, at phase 7's 1b prefill shape
   (B8 S128 H16 KH8 D128), at phase 17's prefill from the imported
   Llama-3-8B-width weights (B4 S128 H32 KH8 D128), at phase 8's training
   shape (B16 S1024), at
   phase 10's (B8 S2048), at phase 11's per-rank shape (B2 S4096), at
   phase 12's ViT-B/16 shape (B128 S197 H12 D64, non-causal: the kernel
   alone on S padded to 256 with kv_len 197, the wrapper's time beside it,
   SDPA on S 197), at phase 13's per-rank tp=2 shapes (0.3b B4 S2048 H4
   KH2; Llama-3-8B B1 S2048 H16 KH4), at phase 14's one-process shape
   (B2 S8192), at phase 15's microbatch (B2 S2048), at a pp=2,tp=2 rank's
   microbatch of 15(e) (B2 S2048 H4 KH2) and at phase 14(b)'s
   token-group reference (B2 S512), with achieved TFLOP/s and the wrapper's
   host time a call.
3. The two backward kernels against their plain version
   (``flash_attention_backward_reference``) on the same padded inputs, in the
   listed cases, by ``grad_agreement`` (relative L2 error over the whole
   gradient, over its late half and per row); at the training shape, at
   phase 8's, at phase 10's, at phase 11's, at phase 12's ViT shape, at
   phase 13's two tp shapes, at phase 14's, at phase 15's two and at phase
   14(b)'s token-group shape each kernel's time, the plain backward's, SDPA's backward on the unpadded S
   (timed only) and each bound (over the pairs the unpadded S needs), and each kernel's host time a call. Then the bf16 gradients of the public, differentiable
   ``flash_attention`` on the card against the plain forward and backward, at
   the training shape and at a padded one.
4. The generate path: ``workloads.generate.run`` at ``llama_0_3b`` full
   width and depth (batch 8, 512-token prompt, 32 new tokens, random weights
   from a seed), launch counts set to 0 just before and read just after (the
   forward kernel once per layer per prefill); the flash prefill's logits
   against the dense model's; a profile of one generate call of
   ``PROFILE_STEPS`` decode steps (run after phase 8: no timed run follows
   a profiler session).
5. The training path: ``workloads.llama_train.run`` at ``llama_0_3b`` full
   width and depth (batch 4 x 4096 tokens, 1 warmup + 5 steps, AdamW, random
   weights from a seed), launch counts set to 0 just before and read just
   after (each of the three kernels once per layer per step; finite losses,
   the last below the first); one step of flash + chunked loss against dense
   attention + dense loss on the same weights (batch 4 x 1024: the loss, the
   global gradient norm and each layer's q/k/v projection gradients); a
   profile of one training step (run after phase 8).
6. The serve path, at ``llama_0_3b`` full width and ``SERVE_LAYERS`` (8)
   of its 16 layers, through ``serve.run``'s ``n_layers`` (random weights
   from a seed, bf16 weights and cache; 8 slots, chunk 128, block 64,
   ``max_decode_len`` 4096): (a) ``workloads.serve.run`` over the file
   spool, fed by a client thread with the engine stream that bench.py
   times (a warmup pair left out of the stats, then 24 requests of prompts
   64-511 and 64-191 new tokens, sent at once), launch counts set to 0 just
   before and read just after (the engine prefills and decodes through the
   cache attention, as the JAX engine does: no flash launch); every
   response whole and in the vocabulary, none rejected; the engine's decode
   tokens/s, TTFT (from submit, and from admission) and TPOT percentiles;
   every emitted token held by teacher forcing on the same weights against
   the prompt serve.run synthesised for its id: the dense model's logits
   over prompt + emitted tokens, the chosen token within ``LOGITS_TOL`` of
   each position's largest logit, and the exact argmax at no less than
   ``SERVE_EXACT_SHARE_MIN`` of the positions; (b) a ``ServingEngine`` on
   the same weights driven directly with edge requests (a prompt of one
   chunk, one a token into a second chunk, one at the cache budget, a
   single-token request, more requests than slots), held the same way;
   (c) the admission of 8 prompts (prefill time a chunk), a decode block
   timed with its peak memory, then (after phase 8) a block of
   ``PROFILE_STEPS`` steps profiled (the card's
   busy share, kernel launches per decode step, device time by kernel, host
   ops by host time) and timed again after the profiler session.
7. The int8 serving stack (int8 weights, int8 KV cache) at ``llama_1b`` full
   width and ``SERVE_LAYERS`` of its 16 layers, random weights from seed 0: (a) bench.py's decode A/B,
   ``generate.run(quantize="int8", kv_quantize="int8",
   compare_unquantized=True)`` at batch 8, 128-token prompts, 128 new
   tokens, ``max_decode_len`` 4096, launch counts set to 0 just before and
   read just after (the forward kernel once per layer per prefill): int8 and
   bf16-control tokens/s, ``int8_speedup``, ``weight_mb``, ``prefill_s``;
   (b) the int8 model loaded alone with ``init_host``: every quantized tensor
   int8 on the card, ``memory_allocated`` within ``AT_REST_MARGIN`` of
   ``state_bytes``, and of ``state_bytes`` plus the cache once an engine
   holds it; its state equal to the one quantized on the card from the same
   seed; its logits within ``INT8_WEIGHT_TOL`` of a bf16 model on its
   weights dequantized apart (no call of the port's dequantization); the kv8 cache
   against references that do not run its code (layer 0's dequantized slabs
   within half a scale of a bf16 cache's, its cache attention within
   ``KV8_ATTN_RTOL`` of dequantize-then-attend); (c) ``serve.run`` with the
   int8 stack on bench.py's engine stream, checked as phase 6(a); (d) every
   stream token held at ``LOGITS_TOL`` and ``SERVE_EXACT_SHARE_MIN`` by a
   kv8 teacher (a batch-1 ``prefill_mode="cache"`` model on the same int8
   weights and an int8 cache, run over prompt and emitted tokens in one
   chunk), and, without a gate, the same tokens against the bf16 dense model
   on the unquantized weights; (e) a decode block of the int8 engine and of
   a bf16 engine at 1b, each timed with its peak memory; the device time of
   one step's dequantization and kv8 writes; the int8 block's profile (run
   last).
8. The journey, train -> checkpoint -> serve on the repo's own text, at
   ``llama_0_3b`` full width and ``SERVE_LAYERS`` of its 16 layers, every
   entry point given ``n_layers`` (bench.py:307-391 on the port): (a)
   bench.py's corpus (the JAX package's sources and the root ``*.md`` files
   as bytes, records of 1024, permuted with seed 0, split 90/10, packed);
   (b) bench.py's training call, ``llama_train.run`` at batch 16 x 1024, 40
   steps after 2 warmup, cosine schedule, remat ``dots``, checkpoints every
   40 steps into ``TPUJOB_CHECKPOINT_DIR``, through the native loader,
   launch counts set to 0 just before and read just after (the forward
   kernel twice a layer a step under remat, the backward kernels once, the
   forward once a layer a held-out batch), its held-out loss below chance
   less one nat; (c) steps 40 and 42 committed with sidecars and verified,
   42 restored into a fresh model and AdamW bit for bit with the run's
   eval loss, a corrupt step 42 planted in a copy and caught (fallback to
   40 with a ``checkpoint_corrupt`` record); one step's loss and gradient
   norm with remat off, ``dots`` and ``full`` on the trained weights, and
   each policy's tokens/s and peak memory over 3 timed steps; (d)
   ``quality_eval.run`` on the checkpoint (bench.py:377-382): fp, int8 and
   int8 + kv8 held-out losses through the serving path, argmax agreement
   and drift over a 256-token greedy rollout (an eighth of the
   reference's, for the script's time budget), and the fp serving loss
   against the training path's on the same rows; (e) ``generate.run``
   with ``restore`` (bf16, then int8 + kv8) and each model's continuation
   of a held-out prompt as bytes; ``serve.run`` with ``restore`` on
   held-out prompts over the spool, every token held by teacher forcing,
   with the teacher's top-2 margins; a profile of one remat training step
   (run last).
9. The rest of the training path at ``llama_0_3b`` full width and depth,
   random weights from a seed, each ``llama_train.run`` with the launch
   counts set to 0 just before and read just after (each kernel once a layer
   a step): (a) adafactor (lr ``ADAFACTOR_LR``) and AdamW runs at phase 5's
   B4 x 4096, 1 warmup + 3 steps (adafactor's losses finite and falling),
   tokens/s, peak memory and optimizer state bytes of each; one adafactor
   update on the card held against the same update on the CPU
   (``ADAFACTOR_CARD_CPU_RTOL``), and each optimizer step's device time by
   CUDA events; (b) on phase 8's corpus at B16 x 1024 without remat, 2
   warmup + 20 steps inline, with ``prefetch=2``, and with ``prefetch=2``,
   autotune, ``prefetch_depth_max=8`` and 2 workers: equal losses step for
   step, tokens/s and the feed's stall and depth; (c) the inline run at 4
   of its 16 layers (0.95 GB a step), 1 + 9 steps, with ``checkpoint_every=5`` into ``TPUJOB_CHECKPOINT_DIR`` and
   ``TPUJOB_STATUS_DIR`` set, blocking and then async: steps 5 and 10
   committed with sidecars and verified, one ``checkpoint_committed`` record
   an async save, each save's return time, the async step 10 restored equal
   bit for bit to the blocking run's (the same training, saved before its
   next step); then async under an ``enospc_checkpoint_write`` plan (the
   save at 10 lost): the run finishes, a ``checkpoint_save_failed`` record,
   and without the run's final save the restore falls back to step 5; (d),
   preemption and resume in ``llama_train`` subprocesses, is given up for
   the time limit (``tests/test_torch_preemption.py`` holds it on the CPU);
   (e) (run last)
   ``llama_train.run`` with ``profile_dir`` at phase 5's shape and
   ``profiling.device_report`` on its trace: the three kernels among its
   ops, its busy time a step within ``PROFILE_BUSY_RTOL`` of phase 5's
   profile, its top 12 printed.
10. The mixture-of-experts Llama (``parallel/moe.py``), with TF32 off: (a)
   the layer at bench.py's moe width (4,096 tokens of bf16 x, D 1024, F 4096,
   8 experts, top 2), one forward and backward of each dispatch on the card
   against the plain f32 run on the CPU on the same values: top-k indices
   equal for at least ``MOE_INDEX_AGREE_MIN`` of the tokens, the output and
   the gradients of x, gate, w_in and w_out within ``MOE_REL_TOL`` by
   relative L2 (output and x's gradient over the tokens routed alike), and
   two planted router faults (top-k weights from the full softmax; the
   second choice dropped) read above it; (b) sparse dispatch at capacity
   factor E/top_k against dense on the card within the same tolerance, and
   the share of (token, choice) pairs dropped at 1.25; (c) bench.py:438-467's
   ``moe`` block through ``llama_train.run`` (0.3b width at 8 layers, 8
   experts, top 2, sparse, capacity 1.25, aux 1e-2, bf16 parameters,
   adafactor, remat ``dots``, B8 x 2048, 3 warmup + 12 steps), then its
   dense twin, each with the launch counts set to 0 just before and read
   just after (the forward kernel twice a layer a step, each backward kernel
   once): tokens/s, step time, peak memory, launches a step, first and last
   losses and aux values; ``params_m`` 627.7 and sparse
   ``active_params_m`` 225.0 held, the first-step losses within
   ``MOE_FIRST_LOSS_TOL``; (d) (run last) one profiled step, sparse and then
   dense: the card's busy time split into the router, the one-hot slot building, the
   dispatch and combine products, the expert products (the layer's
   ``record_function`` ranges, a backward op charged to its forward op's
   range), the flash kernels and the rest.
11. Worlds of two processes on the one card, each rank started as a
   subprocess with the environment the supervisor injects (the ``TPUJOB_*``
   world, ``MASTER_*``, ``WORLD_SIZE``, ``RANK``) and joined by
   ``rendezvous.initialize_from_env``; the two ranks share ``cuda:0``, so
   the backend is gloo (NCCL refuses two ranks on one GPU). (a) Each rank's
   backend and card, and each collective of ``parallel/collectives.py`` on
   CUDA tensors against its value (first, in (c)'s world); (b) ``workloads.smoke_dist`` in both
   ranks, both exit 0; (c) ``llama_train.run`` at ``llama_0_3b`` full width
   and 2 of its 16 layers (the script's time limit), global batch 4 x 4096,
   AdamW, clip 1.0, 1 warmup + 5 steps:
   one process in this one, then two ranks with ``mesh_spec="fsdp=2"`` and
   ``"dp=2"``, each rank's flash launches read from its result (each kernel
   once a layer a step): the two-rank losses within ``DIST_LOSS_ATOL`` of the
   one process's, each rank's parameter and AdamW bytes (about half of the
   one process's under fsdp=2, within ``DIST_HALF_RTOL``; all of them under
   dp=2), its peak memory, step time and tokens/s of two ranks sharing one
   card; (d) the fsdp=2 run saved step 4 asynchronously and step 6 blocking
   into ``TPUJOB_CHECKPOINT_DIR``: both verified, a one-process
   ``restore_subtree`` of step 6 equal bit for bit (a digest) to the ranks'
   gathered parameters, and a two-rank resume from step 4 with the
   uninterrupted run's losses for steps 5-6 bit for bit.
12. The image models (ResNet-50, ViT-B/16), each with random weights from a
   seed: (a) with TF32 off, ResNet-50 in f32 at full width (B2 x 64 px) and
   ViT-B/16 in f32 built for 64 px (17 tokens; dense, and flash against the
   CPU's plain version), one training forward and backward on the card
   against the CPU on the same weights: the logits, every gradient and the
   batch-norm running buffers within ``IMAGE_CARD_CPU_RTOL`` (relative L2),
   and three planted faults on the card read above it (PyTorch's symmetric
   SAME padding, ``nn.BatchNorm2d``'s unbiased running variance, its
   LayerNorm epsilon); (b) the layout (channels_last weights and stem
   output), then ``resnet_bench.run_benchmark`` as examples/resnet.yaml runs
   it (ResNet-50, B128 x 224 px, 1000 classes, 30 steps a window, 3
   windows): images/sec/chip sustained and in the fastest fenced window,
   step time, peak memory, losses, and bench.py's 3 x 4.1 GFLOP an image as
   a share of the dense bf16 peak; then the batch norm's two paths timed on
   that step (``BN_AB_STEPS``); (c) ``resnet_ab`` plain against s2d
   (2 rounds; first-step losses within ``S2D_FIRST_LOSS_ATOL``, a planted
   wrong s2d regrouping above it), then a file the port's ``pack --dataset
   synthetic`` writes under ``TMPDIR`` (1,024 images of 112 px) trained at
   B128, 4 + 4 steps, inline and with ``prefetch=2``, equal losses step for
   step; (d) ResNet-50 in two ranks sharing ``cuda:0`` over gloo (global
   batch norm), global B64, 3 + 3 steps, against one process: the first
   chunk's losses within ``WORLD_LOSS_ATOL``, a planted per-rank batch norm
   (run next in the same world) above it; (e) ``vit_bench`` at ViT-B/16, B128 x 224 px, dense and then
   flash, the launch counts set to 0 just before the flash run and read just
   after (each kernel once a layer a step), images/sec/chip, step time, peak
   memory; flash's losses of steps 2-10 within ``VIT_LOSS_ATOL`` of dense's,
   beside dense bf16's drift from f32, a planted fault (the padded keys
   attended) above it; the kernels at this shape are held and timed in
   phases 2-3 (``VIT_SHAPE``); (f)
   ``workloads.latency_probe`` started twice as the supervisor starts a
   replica: launch -> first step and its phases; (g) (run last) one profiled
   training step of each model, the card's busy time split into convs,
   batch norm and elementwise ops, GEMMs and attention.
13. Tensor parallelism and adafactor under a mesh, ranks sharing
   ``cuda:0`` over gloo as in phase 11 ((a), (b) and (d) in one world of
   two ranks with phase 14(a)-(b)'s and 15(a)-(d)'s runs), each rank's flash launches read from its result (each kernel
   once a layer a step, the forward twice under remat): (a) ``llama_0_3b``
   at 2 of its 16 layers, tp=2, B4 x 2048, AdamW, 1 + 3 steps, against one
   process: losses
   within ``TP_LOSS_ATOL``, a planted fault (tp's leave written with
   ``psum_autograd``, whose backward sums too) above it, each rank's
   parameter bytes exactly its blocks plus the whole norms, peak memory
   and step time; (b) ``llama_0_3b`` at 2 of its 16 layers, fsdp=2 with
   adafactor, f32 and bf16 parameters, against one process's adafactor: losses within
   ``TP_LOSS_ATOL``, each rank's state a part of one process's, and the
   moves of two tensors whose row statistics fsdp splits within
   ``TP_ADA_MOVE_RTOL`` of one process's, a planted fault (the row
   statistics left unreduced over fsdp) above it; (c) ``llama_0_3b`` at 4
   layers on four ranks, fsdp=2,tp=2, 1 + 1 steps (run in phase 15's world
   of four ranks, whose start-up it shares), the ranks' coordinates,
   its checkpoint restored by one process equal (a digest) to the ranks'
   gathered parameters; (d) Llama-3-8B's full width (d_model 4096, 32
   layers, 32/8 heads, d_ff 14336, vocab 128256) at tp=2, bf16
   parameters, adafactor, remat ``full``, B1 x 2048, 1 + 1 steps: finite
   losses, the first within ``TP_8B_FIRST_LOSS_ATOL`` of ln 128256,
   ``params_m`` 8030.3, 8,031,059,968 parameter bytes a rank, peak memory
   and step time.
14. Sequence and expert parallelism, ranks sharing ``cuda:0`` over gloo as
   in phase 13: (a) ``llama_0_3b`` at full width and 2 of its 16 layers,
   global B2 x 8192, AdamW, 1 + 1 steps: one process with
   ``attn_impl="flash"``, then two ranks at ``sp=2`` with ring attention and
   with ulysses (each rank its 4,096 positions): losses within
   ``SP_LOSS_ATOL`` of the one process's, a planted fault (the ring masking
   by each rank's local positions) above it, the sp ranks' parameters equal
   (a digest), no flash launch (the sp schemes run none, as in JAX), each
   rank's peak memory and step time; (b) the MoE Llama at 0.3b width, 4
   layers, 8 experts, top 2, flash, B8 x 2048, 1 + 3 steps: one process,
   then ``ep=2``, dense and then sparse (aux 1e-2): losses within
   ``EP_LOSS_ATOL``, each rank's expert parameter bytes exactly half of one
   process's, the moves of two tensors upstream of the experts within
   ``EP_MOVE_RTOL`` of one process's, a planted fault (ep's leave written
   with ``psum_autograd``) above it, each rank's flash launches (each kernel
   once a layer a step) into the kernels line; in the same world, sparse
   dispatch over token groups that cross ranks (``EP_GROUPS``: capacity 0.5,
   aux 1e-2): one process at B2 x 512 (N 1,024, one group) and at B4 x 512
   with ``grad_accum=2`` (at 2 layers), then (i) ``fsdp=2`` at B2 x 512 with flash (each
   rank one row; the group spans both), (ii) ``sp=2`` ring at B2 x 512 (each
   rank blocks of 256; the group interleaves them), (iii) ``fsdp=2`` at B4 x
   512 with ``grad_accum=2``, (iv) a planted fault, (i) with each rank
   grouping its own tokens: every step's loss and aux loss of (i)-(iii)
   within ``GROUPS_LOSS_ATOL`` of its one process's, (iv)'s losses above it,
   (i)'s and (iii)'s flash launches (each kernel once a layer a microbatch)
   into the kernels line, (ii)'s none; (c) ulysses under tp over the
   global kv heads: ``llama_0_3b`` (4 kv heads) at full width and 2 of its
   16 layers, global B8 x 2048, AdamW, 1 + 1 steps: one process with
   ``attn_impl="flash"`` (its launches into the kernels line), then eight
   ranks at ``sp=2,tp=4`` with ulysses (one kv head a tp rank, gathered over
   tp with q and v before the swap), and a planted fault (the output's
   heads kept at the sp coordinate instead of the tp coordinate): every
   step's loss within ``SP_LOSS_ATOL`` of the one process's and the fault's
   above it, the ranks' gathered parameters equal (a digest), each rank's
   parameter bytes exactly its tp blocks and the whole norms, each rank's
   tp gathers (q, k and v a layer a step), no flash launch, each rank's
   peak memory and step time.
15. Pipeline parallelism, two ranks sharing ``cuda:0`` over gloo in one
   world: ``llama_0_3b`` at full width and 8 of its 16 layers (4 a stage),
   global B8 x 2048, AdamW, 1 + 2 steps (the world is phase 13's). (a)
   One process, then ``pp=2`` with GPipe and with 1F1B at 4 microbatches
   (B2 x 2048 each): every step's loss within ``PP_LOSS_ATOL`` of one process's, each rank's stage
   (rank 0 the embedding) and parameter bytes exactly its stage's (its 4
   layers, the final norm, half the head's vocabulary rows), step time and
   peak memory a rank, each rank's flash launches (each kernel once a layer
   a microbatch) into the kernels line; (b), both schedules at 8
   microbatches (global B16) and their peaks, is given up for the time
   limit (``tests/test_torch_pipeline.py`` holds GPipe's residency and
   1F1B's ring on the CPU); (c) a planted fault
   (each stage backwarding a microbatch's stored graph with the previous
   microbatch's cotangent) above ``PP_LOSS_ATOL``; (d) (a)'s 1F1B run's
   checkpoint (each rank its layers and head rows) restored by one process
   equal (a digest) to the ranks' gathered parameters. Then four ranks in
   one world: (e) ``pp=2,tp=2``, (a)'s model, seed and rows, 1F1B at 4
   microbatches, 1 + 2 steps: every step's loss within ``PP_LOSS_ATOL`` of
   (a)'s one process at the same step, each rank's parameter bytes exactly
   its blocks (its stage's 4 layers as tp blocks with the norms whole, the
   final norm, a quarter of the head's rows nested pp outer and tp inner,
   stage 0 half the embedding), each rank's flash launches (each kernel
   once a layer a microbatch, at ``PPTP_SHAPE``) into the kernels line, a
   planted fault (the head rows of the tp-outer nesting under the loss's
   pp-outer offsets) above ``PP_LOSS_ATOL`` (the world's one checkpoint is
   13(c)'s; (d) restores a pp checkpoint); (f) ``pp=2,ep=2``, the MoE
   Llama at 0.3b width (phase 10's 8 experts, top 2, capacity 1.25, aux
   weight 0, sparse dispatch) at 4 layers, B8 x 2048, 1 + 2 steps: every
   loss within ``EP_LOSS_ATOL`` of its own one process's, each rank's
   expert bytes exactly E/ep of its stage's layers, the launches (at
   ``PP_SHAPE``) into the kernels line; (g) sparse dispatch in pp
   microbatches over data ranks: ``dp=2,pp=2``, (f)'s model at capacity
   0.5, global B8 x 512, 1F1B at 4 microbatches of the global batch's rows
   (a microbatch's B2 x 512 one 1,024-token group, a row on each data rank,
   so the top-k gather crosses ranks), 1 + 2 steps: every loss within
   ``EP_LOSS_ATOL`` of one process accumulating over the same 4
   microbatches (``grad_accum=4``), a planted fault (the feed giving each
   data coordinate its own rows, split into the microbatches) above it, the
   ranks' coordinates and expert bytes (a stage's layers' E experts), each
   rank's launches (each kernel once a layer of its stage a microbatch, at
   a rank's B1 S512) into the kernels line. Step time and peak memory a
   rank.
16. The digit CNN and BERT, random weights from seed 0 (neither path
   launches a flash kernel, as in JAX: 0 launches on their paths): (a) the
   digit CNN in f32 on the card against the CPU (B128 of the digits, TF32
   off), the logits and every gradient within ``MNIST_CARD_CPU_RTOL``
   (relative L2), a planted (c, h, w) flatten above it; (b)
   ``mnist_train.main(["--epochs", "8"])`` in this process as
   examples/mnist.yaml runs it (88 steps of B128 over the 1,438 training
   digits, bf16): exit 0, test accuracy at least ``MNIST_TARGET``, the
   time to the first step, images/sec; (c) the same from a file packed by
   ``pack --dataset digits``, inline and with ``--prefetch 2`` (cuDNN held
   to deterministic algorithms for the pair): exit 0, equal losses step
   for step; (d) ``mnist_train`` in two ranks sharing ``cuda:0`` over gloo
   (dp=2, 2 epochs): both exit 0, every step's loss within
   ``WORLD16_LOSS_ATOL`` of (b)'s; (e) ``bert_fsdp.run`` with bench.py's
   recipe (BERT-base, B64 x S128, 3 warmup + 30 steps, bf16 compute, f32
   parameters, AdamW at a constant 1e-4): sequences/sec/chip, step time and
   its TFLOP/s, peak memory, ``params_m`` ``BERT_PARAMS_M``, finite losses;
   the same with a 10-step warmup and cosine decay (``BERT_LEARN``: the
   constant rate does not learn in 33 steps), ``final_accuracy`` at least
   ``BERT_ACC_MIN``; BERT-base in f32 (B2 x S128, a pad mask) on the card
   against the CPU within ``BERT_CARD_CPU_RTOL``, the mask dropped above
   it; (f) one world of two ranks sharing the card: BERT-base at fsdp=2,
   global B64 x S128, 1 + 3 steps, each rank's parameter and AdamW bytes
   within ``BERT_HALF_RTOL`` of half of (e)'s; at tp=2, the same recipe,
   each rank's parameter bytes exactly ``BERT_TP_BYTES``, the ranks'
   gathered parameters and the tensors tp holds whole equal (digests); at
   sp=2 (replicas), 1 + 1 steps, the ranks' parameters equal: every step's
   loss within ``WORLD16_LOSS_ATOL`` of (e)'s, AdamW bytes, peak memory and
   step time, no flash launch; then the tp=2 model at full width in f32
   (every bias drawn N(0, ``BERT_TP_BIAS_STD``)) against the whole model on
   each rank, the sequence output and the logits within ``BERT_TP_RTOL``
   (relative L2), a planted fault (the row-parallel bias added on both
   ranks) above it.
17. The HF weight import, the FLOP count and the data-plane bench: (a) an
   HF-layout state dict at Llama-3-8B's width (``IMPORT_LAYERS`` of its 32
   layers) drawn in bf16 on the card from a seed, imported by
   ``models/llama_import.py``; the port's ``Llama`` on it in f32 against the
   plain HF-convention forward in f32 (TF32 off) within
   ``IMPORT_LOGITS_ATOL``, a planted mapping fault (two layers' q_proj
   swapped) above it; the bf16 import's seconds and peak memory; generate's
   ``make_generate`` from the imported weights, launch counts set to 0 just
   before and read just after (the forward kernel once a layer in the
   prefill); the export round trip bit for bit; (b) ``ops/flop_count`` on
   phase 5's training step (0.3b, B4 x 4096, AdamW) on meta tensors: the
   total, the matmul and flash shares, the seconds, no launch; (c)
   ``dataplane_bench.run`` at ``DATAPLANE_RUN``: each cell's steps/s,
   stall p50/p99 and verification; every cell verified, no step-thread put
   in a prefetched cell, no step-thread fetch beyond the loss fences in a
   staged cell (and one a state tensor a save in the eager async cells), a
   staged cell with a planted blocking copy counted, the autotuned depth
   within its budget, and the inline cells' stalls ordered staged < async <
   blocking.
18. One ``{"kernels": [...]}`` line, the card's line, and as the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import math
import re
import subprocess
import sys
import time


def _fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def _log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and dense
# bf16 / float32 (non-tensor-core) operations per second.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

# (name, B, S, H, KH, D, causal, kv_len, dtype): the generate prefill shape
# first and the training shape second — both are timed; the first's numbers
# are the forward's in the kernels line. The edge cases meet the bf16
# kernels' tiles (128 query rows a forward or dq CTA, 128 keys a dkv CTA of
# two 64-key warpgroups; 128 keys a forward tile, 64 a dq tile, 64 query rows
# a dkv tile): S 192 leaves the last query tile, and the last dkv CTA's
# second warpgroup, past S; S 64 is one tile smaller than a CTA's rows;
# kv_len 77 ends inside a key tile; G 8 is dkv's longest walk over query
# heads; causal kv_len 100 ends inside a dkv CTA's second warpgroup; kv_len
# 40 leaves that warpgroup wholly masked.
TRAIN_SHAPE = ("train", 4, 4096, 8, 4, 128, True, None, "bfloat16")
# The journey's training shape (phase 8): batch 16 x 1024-byte records.
JOURNEY_SHAPE = ("journey", 16, 1024, 8, 4, 128, True, None, "bfloat16")
# bench.py's moe block (phase 10): batch 8 x 2048.
MOE_SHAPE = ("moe", 8, 2048, 8, 4, 128, True, None, "bfloat16")
# One rank's half of phase 5's global batch (phase 11): batch 2 x 4096.
DIST_SHAPE = ("dist", 2, 4096, 8, 4, 128, True, None, "bfloat16")
# ViT-B/16's attention at 224 px (phase 12): batch 128, 197 tokens (padded to
# 256 for the kernels, the padded keys masked through kv_len 197), 12 heads
# of 64, non-causal. Its bounds count the 197 x 197 pairs the data needs.
VIT_SHAPE = ("vit", 128, 197, 12, 12, 64, False, None, "bfloat16")
# One tp=2 rank's attention (phase 13): 0.3b at B4 x 2048 holds 4 of the 8
# heads and 2 of the 4 kv heads; Llama-3-8B at B1 x 2048 16 of 32 and 4 of 8.
TP_SHAPE = ("tp", 4, 2048, 4, 2, 128, True, None, "bfloat16")
TP8B_SHAPE = ("tp8b", 1, 2048, 16, 4, 128, True, None, "bfloat16")
# Phase 14(a)'s one-process reference: 0.3b at B2 x 8192 (the sp runs' global
# batch). The ep ranks of 14(b) attend at MOE_SHAPE (ep splits no batch).
SP_SHAPE = ("sp", 2, 8192, 8, 4, 128, True, None, "bfloat16")
# A pipeline microbatch of phase 15: 0.3b's global B8 x 2048 in 4 (also a
# pp=2,ep=2 rank's of 15(f): ep splits no batch).
PP_SHAPE = ("pp", 2, 2048, 8, 4, 128, True, None, "bfloat16")
# One pp=2,tp=2 rank's microbatch of phase 15(e): 4 of the 8 heads and 2 of
# the 4 kv heads of B2 x 2048.
PPTP_SHAPE = ("pptp", 2, 2048, 4, 2, 128, True, None, "bfloat16")
# Phase 14(b)'s sparse token groups over ranks: the one-process reference's
# B2 x 512 (and a microbatch of its B4 in two); a world rank holds one row.
# Also a microbatch of 15(g)'s one process accumulating over B8 x 512 in
# four (a dp=2,pp=2 rank's share: one row).
GROUPS_SHAPE = ("groups", 2, 512, 8, 4, 128, True, None, "bfloat16")
EDGE_CASES = [
    ("S192_causal", 2, 192, 8, 4, 128, True, None, "bfloat16"),
    ("S64_one_tile", 2, 64, 8, 4, 128, True, None, "bfloat16"),
    ("kv_len77_D64", 2, 256, 8, 4, 64, False, 77, "bfloat16"),
    ("G8", 2, 256, 8, 1, 128, True, None, "bfloat16"),
    ("causal_kv_len100", 2, 256, 8, 4, 128, True, 100, "bfloat16"),
    ("kv_len40_D64", 2, 192, 8, 4, 64, False, 40, "bfloat16"),
]
# The 1b int8 generate's prefill (phase 7): batch 8, 128-token prompts.
PREFILL_1B = ("prefill_1b", 8, 128, 16, 8, 128, True, None, "bfloat16")
# Generate's prefill from the imported Llama-3-8B-width weights (phase
# 17(a)): batch 4, 128-token prompts, 32 heads over 8 kv heads.
IMPORT_PREFILL = ("import_prefill", 4, 128, 32, 8, 128, True, None, "bfloat16")
FLASH_CASES = [
    ("slice", 8, 512, 8, 4, 128, True, None, "bfloat16"),
    TRAIN_SHAPE,
    PREFILL_1B,
    IMPORT_PREFILL,
    JOURNEY_SHAPE,
    MOE_SHAPE,
    DIST_SHAPE,
    VIT_SHAPE,
    TP_SHAPE,
    TP8B_SHAPE,
    SP_SHAPE,
    PP_SHAPE,
    PPTP_SHAPE,
    GROUPS_SHAPE,
    ("unaligned_S500", 8, 500, 8, 4, 128, True, None, "bfloat16"),
    ("kv_len_noncausal", 4, 512, 8, 4, 128, False, 300, "bfloat16"),
    ("G1", 4, 256, 8, 8, 128, True, None, "bfloat16"),
    ("G2_D64", 4, 256, 8, 4, 64, True, None, "bfloat16"),
    ("f32_no_tf32", 2, 256, 8, 4, 128, True, None, "float32"),
    *EDGE_CASES,
]
# The forward is held by flash_attention.forward_agreement: o by relative L2
# error over the whole tensor, its late half and its worst row (GRAD_RTOL,
# ROW_RTOL below), since a late causal row's o is a few hundredths of the first
# rows'; o and lse also by their largest absolute error (FWD_ATOL: bf16 3e-2,
# f32 2e-5).
#
# The backward cases: the training shape first (timed; its numbers go into
# the kernels line), then padded S, non-causal kv_len, G 1, G 2 with D 64,
# f32 with TF32 off, and the tile-edge cases. Each gradient is held to its plain version by
# flash_attention.grad_agreement: relative L2 error over the whole tensor and
# over its late half within GRAD_RTOL (bf16 5e-3, f32 1e-4), and in its worst
# row within ROW_RTOL (bf16 3e-2, f32 3e-4), so that a fault confined to late
# tiles, whose causal gradients are 50-100x smaller than the first keys',
# shows.
BWD_CASES = [
    TRAIN_SHAPE,
    JOURNEY_SHAPE,
    MOE_SHAPE,
    DIST_SHAPE,
    VIT_SHAPE,
    TP_SHAPE,
    TP8B_SHAPE,
    SP_SHAPE,
    PP_SHAPE,
    PPTP_SHAPE,
    GROUPS_SHAPE,
    ("unaligned_S500", 2, 500, 8, 4, 128, True, None, "bfloat16"),
    ("kv_len_noncausal", 2, 512, 8, 4, 128, False, 300, "bfloat16"),
    ("G1", 2, 256, 8, 8, 128, True, None, "bfloat16"),
    ("G2_D64", 2, 256, 8, 4, 64, True, None, "bfloat16"),
    ("f32_no_tf32", 2, 256, 8, 4, 128, True, None, "float32"),
    *EDGE_CASES,
]
# The public function's bf16 gradients on the card against the plain forward
# and backward: the training shape (no padding) and a padded one (S 500,
# D 80), which exercises the autograd wrapper's pad of do and slice of the
# gradients.
AUTOGRAD_CASES = [TRAIN_SHAPE, ("padded_S500_D80", 2, 500, 8, 4, 80, True, None, "bfloat16")]


# One training step, flash + chunked loss against dense attention + dense
# loss on the same weights: both run bf16 matmuls in f32-accumulated products
# but round p (and the loss's f32 logits against the head's f32 product) at
# different points, which 16 layers carry into the loss and the gradients.
# Loss and global gradient norm (readings 3.7e-5 and 6.9e-5, NVIDIA H100 80GB
# HBM3 at 700 W) are held about 10x above their readings. The global norm is
# dominated by the embedding and LM head, so each layer's q/k/v projection
# gradient, which only a right attention backward gets right, is held as a
# relative L2 difference; dense rounds its bf16 dprobs before the softmax
# backward's subtraction, so these differ at the 1e-2 level.
TRAIN_LOSS_RTOL = 5e-4
TRAIN_GRAD_NORM_RTOL = 1e-3
TRAIN_QKV_GRAD_RTOL = 5e-2  # readings: median 1.3e-2, worst layer 2.0e-2
# Flash vs dense prefill, last-position logits: both run bf16 attention and
# differ in where they round (the kernel rounds unnormalized p to bf16 and
# divides after p·v; dense normalizes, then rounds), which 16 layers carry
# into the f32 logits.
LOGITS_TOL = 0.15
# Decode steps under the profiler (a generate call's, a serve block's): the
# profiler's post-processing takes about a millisecond an event, and a 1b
# int8 step launches 1,845 kernels at 16 layers (4 steps for the script's
# time budget; the readings are a step's).
PROFILE_STEPS = 4
# Readings of the profiles that a later one is held against (phase 9(e)
# against phase 5's training step).
PROFILE_READINGS: dict = {}


def _time_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn()`` in ms: CUDA events around ``reps`` calls,
    enqueued behind a sleep kernel so that host overhead between launches
    does not leave the card idle inside the timed interval."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_us(fn, reps: int = 50) -> float:
    """Host time of one ``fn()`` in µs: the wrapper, its tensor-map encodes
    and the launch, enqueued behind a sleep kernel so that no call waits on
    the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * host / reps


def _flash_bound_ms(B, S, H, KH, D, causal, kv_len, dtype) -> tuple:
    """Least time for one flash forward on this card: each input read once,
    each output written once, against the two matmuls over the (row, col)
    pairs that this case's mask keeps."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * (2 * B * S * H * D + 2 * B * S * KH * D) + 4 * B * H * S
    ops = 4 * D * B * H * _causal_pairs(S, causal, kv_len)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _tflops(products: int, B, S, H, D, causal, kv_len, ms: float) -> float:
    """Achieved TFLOP/s of ``products`` matmuls over the live (row, col)
    pairs (2·D operations a pair each) in ``ms``."""
    return 2 * D * products * B * H * _causal_pairs(S, causal, kv_len) / (ms * 1e-3) / 1e12


def _causal_pairs(S, causal, kv_len) -> int:
    cols = kv_len or S
    return sum(min(r + 1, cols) for r in range(S)) if causal else S * cols


def _bwd_bound_ms(kernel, B, S, H, KH, D, causal, kv_len, dtype) -> tuple:
    """Least time for one backward kernel on this card: q, k, v, do, lse and
    delta read once and its gradients written once, against its products
    over the live (row, col) pairs — dq three (q·kᵀ, do·vᵀ, ds·k), dkv four
    (k·qᵀ, v·doᵀ, pᵀ·do, dsᵀ·q), 2·D operations a pair each."""
    esize = 2 if dtype == "bfloat16" else 4
    q_bytes, kv_bytes = esize * B * S * H * D, esize * B * S * KH * D
    rows = 4 * B * H * S  # one f32 row vector
    if kernel == "flash_bwd_dq":
        nbytes, products = 3 * q_bytes + 2 * kv_bytes + 2 * rows, 3
    else:
        nbytes, products = 2 * q_bytes + 4 * kv_bytes + 2 * rows, 4
    ops = 2 * D * products * B * H * _causal_pairs(S, causal, kv_len)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# The kernel a line of ptxas's report is about, from the mangled name of the
# entry it follows: (name, head width) of flash_bwd_dkv_sm90<128> and the like.
_PTXAS_KERNEL = re.compile(r"(?:entry function '|Function properties for )\w*(flash_\w+?)ILi(\d+)E")


def phase_identity_and_build():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        _fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    _log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from pytorch_operator_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build(["flash_fwd", "flash_bwd"])
    _log(f"built {sorted(paths)} in {time.perf_counter() - t0:.2f}s")
    serialised = []
    for name, report in _build.build_logs.items():
        kernel = name
        for line in report.splitlines():
            entry = _PTXAS_KERNEL.search(line)
            if entry:
                kernel = f"{entry.group(1)}<{entry.group(2)}>"
            if any(w in line for w in ("registers", "spill", "warning", "C7520", "Performance Loss")):
                _log(f"ptxas {kernel}: {line.strip()}")
            # ptxas's note that it serialised a kernel's wgmmas (one issued
            # under a condition): a silent slowdown of a kernel that is right.
            if "C7520" in line or "Performance Loss" in line:
                serialised.append(f"{kernel}: {line.strip()}")
    missing = sorted(set(paths) - set(_build.build_logs))
    _log(f"ptxas wgmma serialisation notes: {len(serialised)}"
         + (f" (libraries reused, not checked: {missing})" if missing else ""))
    if serialised:
        _fail(f"ptxas serialised wgmma: {serialised}")
    from pytorch_operator_tpu_torch.ops import flash_attention as fa

    lib = fa._kernel_lib("flash_bwd")
    _log("flash_bwd_dkv_sm90 dynamic shared memory: "
         + ", ".join(f"D{d} {lib.flash_bwd_dkv_smem(d)} B" for d in fa.KERNEL_HEAD_DIMS))
    return card


def phase_flash_vs_plain():
    import torch
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    entry = None
    for name, B, S, H, KH, D, causal, kv_len, dtype in FLASH_CASES:
        dt = getattr(torch, dtype)
        q, k, v = (
            torch.randn((B, S, h, D), generator=gen, device="cuda", dtype=torch.float32).to(dt)
            for h in (H, KH, KH)
        )
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, kv_len=kv_len)
        torch.cuda.synchronize()
        # The plain version on the same (padded) inputs, on the card.
        _, _, S_pad, D_pad = fa._plan_tiling(S, D, 1024, 1024, True)
        pad = (0, D_pad - D, 0, 0, 0, S_pad - S)
        qp, kp, vp = (F.pad(x, pad) for x in (q, k, v))
        kv = kv_len or S
        scale = 1.0 / math.sqrt(D)
        o_ref, lse_ref = fa.flash_attention_reference(qp, kp, vp, causal=causal, kv_len=kv, scale=scale)
        o_ref, lse_ref = o_ref[:, :S, :, :D], lse_ref[:, :S]
        if not torch.isfinite(o.float()).all() or o.shape != (B, S, H, D):
            _fail(f"flash_fwd {name}: non-finite output or shape {tuple(o.shape)}")
        a = fa.forward_agreement(o, lse, o_ref, lse_ref, S)
        err = max(a["max_abs"], a["lse_max_abs"])
        _log(
            f"flash_fwd {name} {dtype}: o rel {a['rel']:.3e}, late half {a['rel_late']:.3e} "
            f"(tol {fa.GRAD_RTOL[o.dtype]:.0e}), worst row {a['rel_row']:.3e} (tol "
            f"{fa.ROW_RTOL[o.dtype]:.0e}); max_abs_err o {a['max_abs']:.3e}, lse "
            f"{a['lse_max_abs']:.3e} (tol {fa.FWD_ATOL[o.dtype]:.0e}) {'ok' if a['ok'] else 'FAIL'}"
        )
        if not a["ok"]:
            _fail(f"flash_fwd disagrees with its plain version in case {name}")
        if name in ("slice", "train", "prefill_1b", "import_prefill", "journey", "moe", "dist", "vit",
                    "tp", "tp8b", "sp", "pp", "pptp", "groups"):
            qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            call = functools.partial(fa.flash_attention_with_lse, q, k, v, causal=causal, kv_len=kv_len)
            wrapper_ms = None
            if S_pad != S:
                # The kernel alone, on the inputs the wrapper pads for it; the
                # wrapper's time (its pad and slice copies) beside it.
                wrapper_ms = _time_ms(call)
                call = functools.partial(fa._launch, qp, kp, vp, causal=causal, kv_len=kv, scale=scale)
            ms = _time_ms(call)
            host_us = _host_us(call)
            plain_ms = _time_ms(
                lambda: fa.flash_attention_reference(q, k, v, causal=causal, kv_len=kv, scale=scale),
                reps=5,
            )
            library_ms = _time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, enable_gqa=True)
            )
            bound_ms, bound_by = _flash_bound_ms(B, S, H, KH, D, causal, kv_len, dtype)
            _log(
                f"flash_fwd {name} timing: kernel {ms:.4f} ms "
                f"({_tflops(2, B, S, H, D, causal, kv_len, ms):.1f} TFLOP/s), plain "
                f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
                f"host {host_us:.1f} us a call"
            )
            readings = {
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library_ms,
                "shape": f"B{B} S{S} H{H} KH{KH} D{D} {'causal' if causal else 'full'} {dtype}",
            }
            if wrapper_ms is not None:
                readings["wrapper_ms"] = wrapper_ms
                _log(f"flash_fwd {name}: the wrapper (pad to S {S_pad}, kernel, slice) {wrapper_ms:.4f} ms")
            if name != "slice":
                # The other timed shapes' readings, keyed by the case's name.
                entry.update({f"{name}_{key}": value for key, value in readings.items()})
                continue
            entry = {
                "name": "flash_fwd",
                "route": "cuda",
                "source": "pytorch_operator_tpu_torch/ops/csrc/flash_fwd.cu",
                "replaces": "pytorch_operator_tpu/ops/flash_attention.py:101",
                "kernel_ms": ms,
                **readings,
            }
    return [entry]


def _padded_case(gen, B, S, H, KH, D, dtype):
    """Random q, k, v, do for one case, padded as the wrapper pads them."""
    import torch
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.ops import flash_attention as fa

    dt = getattr(torch, dtype)
    _, _, S_pad, D_pad = fa._plan_tiling(S, D, 1024, 1024, True)
    pad = (0, D_pad - D, 0, 0, 0, S_pad - S)
    return [
        F.pad(torch.randn((B, S, h, D), generator=gen, device="cuda").to(dt), pad)
        for h in (H, KH, KH, H)
    ]


def phase_backward_vs_plain():
    """Both backward kernels against their plain version on the same padded
    inputs (the forward kernel's o and lse), every case; times and bounds at
    the training shape."""
    import torch
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    entries = {}
    for name, B, S, H, KH, D, causal, kv_len, dtype in BWD_CASES:
        q, k, v, do = _padded_case(gen, B, S, H, KH, D, dtype)
        args = dict(causal=causal, kv_len=kv_len or S, scale=1.0 / math.sqrt(D))
        o, lse = fa._launch(q, k, v, **args)
        grads = fa._launch_bwd(q, k, v, o, lse, do, **args)
        torch.cuda.synchronize()
        refs = fa.flash_attention_backward_reference(q, k, v, o, lse, do, **args)
        errs = {
            gname: _check_grad(f"flash_bwd {name} {dtype} {gname}", g, r, S)
            for gname, g, r in zip(("dq", "dk", "dv"), grads, refs)
        }
        del refs
        if name not in ("train", "journey", "moe", "dist", "vit", "tp", "tp8b", "sp", "pp", "pptp", "groups"):
            continue
        lse_c, delta = lse.contiguous(), fa.bwd_delta(o, do)
        kin = (q, k, v, do, lse_c, delta)
        dq_call = functools.partial(fa._launch_dq, *kin, **args)
        dq_ms, dq_host_us = _time_ms(dq_call), _host_us(dq_call)
        dkv_call = functools.partial(fa._launch_dkv, *kin, **args)
        dkv_ms, dkv_host_us = _time_ms(dkv_call), _host_us(dkv_call)
        plain_ms = _time_ms(
            lambda: fa.flash_attention_backward_reference(q, k, v, o, lse, do, **args), reps=3
        )
        # SDPA on the unpadded S (the same function on the rows the data has).
        qh, kh, vh = (x[:, :S, :, :D].transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, enable_gqa=True)
        doh = do[:, :S, :, :D].transpose(1, 2).contiguous()
        library_ms = _time_ms(
            lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True)
        )
        shape = f"B{B} S{S} H{H} KH{KH} D{D} {'causal' if causal else 'full'} {dtype}"
        for kname, ms, err in (
            ("flash_bwd_dq", dq_ms, errs["dq"]),
            ("flash_bwd_dkv", dkv_ms, max(errs["dk"], errs["dv"])),
        ):
            bound_ms, bound_by = _bwd_bound_ms(kname, B, S, H, KH, D, causal, kv_len, dtype)
            products = 3 if kname == "flash_bwd_dq" else 4
            _log(
                f"{kname} {name} timing: kernel {ms:.4f} ms "
                f"({_tflops(products, B, S, H, D, causal, kv_len, ms):.1f} TFLOP/s), plain "
                f"backward {plain_ms:.4f} ms, SDPA backward {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by})"
            )
            readings = {
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library_ms,
                "shape": shape,
            }
            if name != "train":
                # The other timed shape's readings, keyed by the case's name.
                entries[kname].update({f"{name}_{key}": value for key, value in readings.items()})
                continue
            entries[kname] = {
                "name": kname,
                "route": "cuda",
                "source": "pytorch_operator_tpu_torch/ops/csrc/flash_bwd.cu",
                "replaces": "pytorch_operator_tpu/ops/flash_attention.py:"
                + ("156" if kname == "flash_bwd_dq" else "197"),
                "kernel_ms": ms,
                **readings,
            }
        _log(
            f"backward {name}: dq + dkv {dq_ms + dkv_ms:.4f} ms (SDPA backward "
            f"{library_ms:.4f} ms); host a call: flash_bwd_dq {dq_host_us:.1f} us, "
            f"flash_bwd_dkv {dkv_host_us:.1f} us"
        )
        del out, qh, kh, vh
    torch.cuda.empty_cache()
    _autograd_vs_plain(gen)
    return [entries["flash_bwd_dq"], entries["flash_bwd_dkv"]]


def _check_grad(what: str, g, r, seq_len: int) -> float:
    """Hold one kernel gradient to its plain version (``grad_agreement``);
    log the readings, fail on disagreement, return the max abs error."""
    import torch

    from pytorch_operator_tpu_torch.ops import flash_attention as fa

    if not torch.isfinite(g.float()).all() or g.shape != r.shape:
        _fail(f"{what}: non-finite or of shape {tuple(g.shape)}")
    a = fa.grad_agreement(g, r, seq_len)
    _log(
        f"{what}: rel {a['rel']:.3e}, late half {a['rel_late']:.3e} (tol "
        f"{fa.GRAD_RTOL[g.dtype]:.0e}), worst row {a['rel_row']:.3e} (tol "
        f"{fa.ROW_RTOL[g.dtype]:.0e}); max_abs_err {a['max_abs']:.3e} {'ok' if a['ok'] else 'FAIL'}"
    )
    if not a["ok"]:
        _fail(f"{what} disagrees with its plain version")
    return a["max_abs"]


def _autograd_vs_plain(gen):
    """bf16 gradients of ``flash_attention`` through autograd on the card
    (forward kernel, both backward kernels, the wrapper's padding) against
    the plain forward and backward on the same, unpadded inputs."""
    import torch

    from pytorch_operator_tpu_torch.ops import flash_attention as fa

    for name, B, S, H, KH, D, causal, kv_len, dtype in AUTOGRAD_CASES:
        dt = getattr(torch, dtype)
        q, k, v, do = (
            torch.randn((B, S, h, D), generator=gen, device="cuda").to(dt) for h in (H, KH, KH, H)
        )
        qkv = [x.requires_grad_() for x in (q, k, v)]
        grads = torch.autograd.grad(fa.flash_attention(*qkv, causal=causal), qkv, do)
        q, k, v = (x.detach() for x in qkv)
        args = dict(causal=causal, kv_len=S, scale=1.0 / math.sqrt(D))
        o, lse = fa.flash_attention_reference(q, k, v, **args)
        refs = fa.flash_attention_backward_reference(q, k, v, o, lse, do, **args)
        for gname, g, r in zip(("dq", "dk", "dv"), grads, refs):
            _check_grad(f"autograd {name} {dtype} {gname}", g, r, S)
        del grads, refs, o, lse
    torch.cuda.empty_cache()


def _record_launches(kernels, path: str, launches: dict) -> None:
    for k in kernels:
        k.setdefault("launches_by_path", {})[path] = launches[k["name"]]


def phase_generate(kernels):
    import dataclasses

    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import generate

    fa.reset_launch_count()
    result = generate.run(
        config="0.3b", batch_size=8, prompt_len=512, max_new_tokens=32,
        device="cuda", log=_log,
    )
    launches = fa.launch_counts()
    _log(f"generate path launches: {launches}")
    _record_launches(kernels, "generate", launches)
    n_layers = llama_lib.llama_0_3b().n_layers
    if result["flash_launches_per_generate"] != n_layers:
        _fail(
            f"flash kernel launched {result['flash_launches_per_generate']} times per "
            f"generate call, expected {n_layers} (one per layer)"
        )
    # run(): 1 + 3 timed generate calls and 3 timed prefills, each one prefill.
    if launches["flash_fwd"] != 7 * n_layers:
        _fail(f"flash kernel launched {launches['flash_fwd']} times, expected {7 * n_layers}")
    _log(
        f"generate 0.3b: {result['value']} tok/s, generate {result['generate_s']:.4f} s, "
        f"prefill_s {result['prefill_s']:.5f}"
    )

    # Flash vs dense attention on the same weights: last-position logits.
    cfg = llama_lib.llama_0_3b(decode=True, max_decode_len=512 + 32)
    flash_model, _ = generate.load_params(cfg, config="0.3b", device="cuda", seed=1, log=_log)
    dense_model = llama_lib.Llama(dataclasses.replace(cfg, attn_impl="dense"), device="meta")
    dense_model.load_state_dict(flash_model.state_dict(), assign=True)
    prompt = torch.randint(
        0, cfg.vocab_size, (8, 512), device="cuda", generator=torch.Generator("cuda").manual_seed(2)
    )
    logits = {}
    with torch.no_grad():
        for name, model in (("flash", flash_model), ("dense", dense_model)):
            cache = generate.init_cache(model, 8)
            hidden, _ = llama_lib.decode_forward(model, cache, prompt)
            logits[name] = hidden[:, -1].float() @ model.head_kernel()
    lf, ld = logits["flash"], logits["dense"]
    if lf.shape != (8, cfg.vocab_size) or not torch.isfinite(lf).all():
        _fail(f"flash prefill logits non-finite or of shape {tuple(lf.shape)}")
    err = (lf - ld).abs().max().item()
    agree = (lf.argmax(-1) == ld.argmax(-1)).float().mean().item()
    _log(
        f"prefill logits flash vs dense: max_abs_err {err:.4f} (tol {LOGITS_TOL}), "
        f"logit scale {ld.abs().max().item():.3f}, argmax agreement {agree:.3f}"
    )
    if err > LOGITS_TOL:
        _fail("flash and dense prefill logits disagree")
    return _profile_generate


def _profile_generate(new_tokens: int = PROFILE_STEPS + 1):
    """Where one generate call's time goes: torch.profiler over one call
    (batch 8, 512-token prompt), device time by kernel and the card's busy
    share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.workloads import generate

    cfg = llama_lib.llama_0_3b(decode=True, max_decode_len=512 + new_tokens)
    model, _ = generate.load_params(cfg, config="0.3b", device="cuda", seed=1, log=_log)
    prompt = torch.randint(
        0, cfg.vocab_size, (8, 512), device="cuda", generator=torch.Generator("cuda").manual_seed(2)
    )
    gen = generate.make_generate(model, max_new_tokens=new_tokens)
    cache = generate.init_cache(model, prompt.shape[0])
    gen(cache, prompt, torch.Generator("cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen(cache, prompt, torch.Generator("cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report_profile(prof, wall, f"one generate call ({new_tokens - 1} decode steps)")


def _report_profile(prof, wall: float, what: str, top: int = 12) -> tuple:
    """Device time by kernel from a torch.profiler run (user annotations'
    ranges left out: their kernels are counted as themselves), the card's
    busy share of the wall time, and the number of kernel launches. Returns
    (busy seconds, launches)."""
    import torch

    # A user annotation's range on the card (``Optimizer.step#AdamW.step``)
    # spans kernels that are rows of their own: not counted twice.
    rows = [
        (e.key, e.device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]
    busy_us = sum(t for _, t, _ in rows)
    launches = sum(n for _, _, n in rows)
    _log(
        f"profile of {what}: wall {1e3 * wall:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
        f"({100 * busy_us / 1e6 / wall:.1f}% of wall; profiler on), "
        f"{launches} kernel launches"
    )
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:top]:
        _log(f"  {t / 1e3:9.3f} ms  {n:6d}x  {key[:100]}")
    return busy_us / 1e6, launches


def phase_train(kernels):
    """The training main path at llama_0_3b, then flash + chunked against
    dense on the same weights. Returns the profile of one step, to run
    later."""
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import llama_train

    warmup, steps = 1, 5
    fa.reset_launch_count()
    result = llama_train.run(
        config="0.3b", batch_size=4, seq_len=4096, steps=steps, warmup=warmup,
        device="cuda", log=_log,
    )
    launches = fa.launch_counts()
    _log(f"training path launches: {launches}")
    _record_launches(kernels, "train", launches)
    n_layers = llama_lib.llama_0_3b().n_layers
    for name, n in launches.items():
        if n != n_layers * (warmup + steps):
            _fail(f"{name} launched {n} times on the training path, expected "
                  f"{n_layers * (warmup + steps)} (one per layer per step)")
    losses = result["losses"]
    if len(losses) != warmup + steps or not all(math.isfinite(x) for x in losses):
        _fail(f"training losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        _fail(f"training loss did not fall: {losses}")
    _log(
        f"train 0.3b (B4 x S4096): {result['value']} tokens/s, step {result['step_s']:.4f} s, "
        f"peak memory {result['peak_mem_bytes'] / 2**30:.2f} GiB, "
        f"losses {[round(x, 4) for x in losses]}, per step {result['flash_launches_per_step']}"
    )
    _train_parity()
    return _profile_train


def _train_model(cfg, seed: int):
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib

    model = llama_lib.Llama(cfg, device="cuda")
    return model.init_weights(torch.Generator(device="cuda").manual_seed(seed))


def _train_parity(B: int = 4, S: int = 1024):
    """One step's loss, global gradient norm and each layer's q/k/v
    projection gradients: flash attention + chunked loss against dense
    attention + dense loss, on the same weights."""
    import dataclasses

    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.workloads import llama_train, trainer

    cfg = llama_lib.llama_0_3b()
    flash = _train_model(cfg, seed=3)
    toks = torch.from_numpy(llama_train.synthetic_bigram_batch(B, S, cfg.vocab_size, 0))
    toks = toks.to("cuda", torch.long)
    out = {}
    for name in ("flash", "dense"):
        if name == "flash":
            model = flash
        else:
            model = llama_lib.Llama(
                dataclasses.replace(cfg, attn_impl="dense", xent_impl="dense"), device="cuda"
            )
            model.load_state_dict(flash.state_dict())
            del flash
        loss = trainer.make_lm_loss_fn(model)(toks)
        loss.backward()
        gnorm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad) for p in model.parameters()])
        )
        qkv = {
            f"{i}.{proj}": getattr(layer.attn, proj).weight.grad
            for i, layer in enumerate(model.layers)
            for proj in ("q_proj", "k_proj", "v_proj")
        }
        out[name] = (float(loss.detach()), float(gnorm), qkv)
        del model, loss
    (lf, gf, qf), (ld, gd, qd) = out["flash"], out["dense"]
    dl, dg = abs(lf - ld) / abs(ld), abs(gf - gd) / gd
    dqkv = {
        key: (torch.linalg.vector_norm(qf[key] - qd[key]) / torch.linalg.vector_norm(qd[key])).item()
        for key in qd
    }
    worst = max(dqkv, key=dqkv.get)
    _log(
        f"train step flash+chunked vs dense (B{B} x S{S}): loss {lf:.5f} vs {ld:.5f} "
        f"(rel {dl:.2e}, tol {TRAIN_LOSS_RTOL:.0e}); grad norm {gf:.5f} vs {gd:.5f} "
        f"(rel {dg:.2e}, tol {TRAIN_GRAD_NORM_RTOL:.0e}); q/k/v projection gradients: "
        f"worst layer {worst} rel {dqkv[worst]:.2e}, median "
        f"{sorted(dqkv.values())[len(dqkv) // 2]:.2e} (tol {TRAIN_QKV_GRAD_RTOL:.0e})"
    )
    if (
        not (math.isfinite(lf) and math.isfinite(gf))
        or dl > TRAIN_LOSS_RTOL
        or dg > TRAIN_GRAD_NORM_RTOL
        or not dqkv[worst] <= TRAIN_QKV_GRAD_RTOL
    ):
        _fail("flash + chunked and dense training steps disagree")
    torch.cuda.empty_cache()


def _profile_train(B: int = 4, S: int = 4096):
    """Where one training step's time goes at the training shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.workloads import llama_train, trainer

    cfg = llama_lib.llama_0_3b()
    model = _train_model(cfg, seed=4)
    step = trainer.make_lm_train_step(model, trainer.make_optimizer(model.parameters(), 3e-4))
    toks = torch.from_numpy(llama_train.synthetic_bigram_batch(B, S, cfg.vocab_size, 0))
    toks = toks.to("cuda", torch.long)
    float(step(toks))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(toks))
        wall = time.perf_counter() - t0
    busy, _ = _report_profile(prof, wall, f"one training step (B{B} x S{S})", top=15)
    PROFILE_READINGS["train_busy_s"] = busy
    del model, step
    torch.cuda.empty_cache()


# The serve path's knobs: examples/serve.yaml's, without int8.
SERVE_KNOBS = dict(slots=8, chunk=128, block=64, max_decode_len=4096)
# Phases 6, 7 and 8 serve at half the presets' depth, 8 of their 16 layers,
# at full width (the script's time budget: the engine's decode is host
# bound, its time a step about proportional to the layers).
SERVE_LAYERS = 8
# Teacher forcing holds every greedy token the engine emits within LOGITS_TOL
# of its position's largest logit, and the exact argmax at no less than this
# share of a run's positions. The engine decodes at batch 8 and the dense
# model runs batch 1, so bf16 rounds apart, and random weights' logits lie
# close: a sound engine chose the exact argmax at 0.969 of the edge requests'
# positions, one whose admitted slot starts a position late at 0.882 (NVIDIA
# H100 80GB HBM3 at 700 W).
SERVE_EXACT_SHARE_MIN = 0.925


def _bench_stream(vocab: int):
    """The engine stream that bench.py times (bench.py:550-571): a warmup
    pair, then 24 requests of 64-511 prompt and 64-191 new tokens, their
    lengths drawn from the same seed-0 generator in the same order (the draws
    of bench.py's prompt tokens kept in step). Returns ``(warmup, stream)``,
    lists of ``(prompt_len, max_new_tokens)``."""
    import numpy as np

    rng = np.random.default_rng(0)
    warmup = [(100, 33), (260, 33)]
    for p, _ in warmup:
        rng.integers(0, vocab, (p,))
    stream = []
    for _ in range(24):
        p, n = int(rng.integers(64, 512)), int(rng.integers(64, 192))
        rng.integers(0, vocab, (p,))
        stream.append((p, n))
    return warmup, stream


def _pct(xs, q: float) -> float:
    """``ServingEngine.stats``'s percentile rule."""
    xs = sorted(xs)
    return round(xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))], 3)


def _teacher_gaps(model, margins=None):
    """The dense non-decode model over ``model``'s tensors (no copy). Returns
    ``gaps(prompt, tokens)``: at each generated position, the largest logit
    less the emitted token's, on the host. With ``margins`` (a list), each
    call also appends the largest logit less the second at each position:
    how far apart the model's choices lie."""
    import dataclasses

    import numpy as np
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib

    teacher = llama_lib.Llama(
        dataclasses.replace(model.cfg, decode=False, attn_impl="dense"), device="meta"
    )
    teacher.load_state_dict(model.state_dict(), assign=True)
    head = teacher.head_kernel().float()

    @torch.no_grad()
    def gaps(prompt, toks):
        p, n = len(prompt), len(toks)
        seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])
        hidden = teacher(torch.from_numpy(seq).long().cuda()[None], return_hidden=True)
        logits = hidden[0, p - 1 :].float() @ head  # [n, V]: position p-1+i predicts token i
        chosen = logits[torch.arange(n), torch.tensor(toks, device="cuda")]
        if margins is not None:
            top2 = logits.topk(2, dim=-1).values
            margins.append((top2[:, 0] - top2[:, 1]).cpu())
        return (logits.max(-1).values - chosen).cpu()

    return gaps


def _hold_gaps(what: str, gaps: dict) -> None:
    """Fail unless every teacher-forced gap is within LOGITS_TOL and the
    exact argmax share reaches SERVE_EXACT_SHARE_MIN."""
    worst = max(gaps, key=lambda k: float(gaps[k].max()))
    exact = sum(int((g == 0).sum()) for g in gaps.values())
    total = sum(len(g) for g in gaps.values())
    _log(
        f"{what}: {len(gaps)} requests, {total} tokens teacher-forced; worst gap "
        f"{float(gaps[worst].max()):.4f} ({worst}; tol {LOGITS_TOL}); exact argmax share "
        f"{exact / total:.4f} (min {SERVE_EXACT_SHARE_MIN})"
    )
    if not float(gaps[worst].max()) <= LOGITS_TOL:
        _fail(f"{what}: an emitted token is not within LOGITS_TOL of its teacher-forced argmax")
    if not exact / total >= SERVE_EXACT_SHARE_MIN:
        _fail(f"{what}: the exact argmax share is below {SERVE_EXACT_SHARE_MIN}")


def _serve_stream(config: str, cfg, **run_kw):
    """``workloads.serve.run`` over the file spool, fed by a client thread with
    bench.py's engine stream (the warmup pair answered first, then the 24
    requests sent at once), launch counts set to 0 just before and read just
    after. Fails unless every response is whole and in the vocabulary, none
    is rejected and no flash kernel ran (the engine prefills and decodes
    through the cache attention, as the JAX engine does). Returns
    ``(stats, responses by id as (prompt_len, new, response), stream ids,
    launches)``."""
    import tempfile
    import threading

    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.serving import Spool
    from pytorch_operator_tpu_torch.workloads import serve

    warmup, stream = _bench_stream(cfg.vocab_size)
    got, stream_ids, errors = {}, [], []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as spool_dir:
        spool = Spool(spool_dir)

        def client():
            # The warmup pair is answered before the stream is sent, so the
            # stats that serve.run resets after it hold the stream alone.
            try:
                for batch in (warmup, stream):
                    ids = [spool.submit(prompt_len=p, max_new_tokens=n) for p, n in batch]
                    if batch is stream:
                        stream_ids.extend(ids)
                    for rid, (p, n) in zip(ids, batch):
                        got[rid] = (p, n, spool.wait_response(rid, timeout=900))
            except Exception as e:  # reported below: the phase fails on it
                errors.append(repr(e))

        thread = threading.Thread(target=client, daemon=True)
        thread.start()
        fa.reset_launch_count()
        stats = serve.run(
            config=config, n_layers=cfg.n_layers, spool_dir=spool_dir, **SERVE_KNOBS,
            max_requests=len(warmup) + len(stream), warmup=len(warmup), idle_timeout=300,
            seed=0, device="cuda", log=_log, **run_kw,
        )
        launches = fa.launch_counts()
        thread.join(timeout=120)
    _log(f"serve path launches ({config}, {run_kw or 'bf16'}): {launches}")
    if errors or thread.is_alive():
        _fail(f"serve client failed: {errors or 'still waiting'}")
    n_all = len(warmup) + len(stream)
    if (stats["served"], stats["rejected"], len(got), stats["requests"]) != (n_all, 0, n_all, len(stream)):
        _fail(
            f"served {stats['served']}, rejected {stats['rejected']}, answered {len(got)}, "
            f"{stats['requests']} in the stats"
        )
    for rid, (p, n, r) in got.items():
        toks = r.get("tokens") or []
        if (
            len(toks) != n or r["prompt_len"] != p or not r["ttft_ms"] > 0
            or not all(0 <= t < cfg.vocab_size for t in toks)
        ):
            _fail(f"serve response {rid}: {len(toks)} tokens of {n}, prompt {r.get('prompt_len')}, "
                  f"ttft_ms {r.get('ttft_ms')}")
    if any(launches.values()):
        _fail("the serve path launched a flash kernel: the engine prefills through the cache")
    own = [got[rid][2]["ttft_ms"] - got[rid][2]["admit_wait_ms"] for rid in stream_ids]
    _log(
        f"serve {config} {run_kw or 'bf16'}, bench.py's engine stream ({len(stream)} requests after "
        f"a warmup pair, sent at once into {SERVE_KNOBS['slots']} slots; prompts "
        f"{min(p for p, _ in stream)}-{max(p for p, _ in stream)}, new {min(n for _, n in stream)}-"
        f"{max(n for _, n in stream)}, {sum(n for _, n in stream)} tokens): decode "
        f"{stats['decode_tokens_per_sec']} tok/s; TTFT from submit (queueing behind the slots "
        f"included) p50 {stats['ttft_ms_p50']} ms p99 {stats['ttft_ms_p99']} ms; TTFT from admission "
        f"(the request's own prefill and first token) p50 {_pct(own, 0.5)} ms p99 {_pct(own, 0.99)} "
        f"ms; TPOT p50 {stats['tpot_ms_p50']} ms p99 {stats['tpot_ms_p99']} ms"
    )
    return stats, got, stream_ids, launches


def _stream_gaps(gaps, vocab: int, got, stream_ids) -> dict:
    """Teacher-forced gaps of every stream response, against the prompt
    serve.run synthesised for its id (crc32 of the id)."""
    import zlib

    import numpy as np

    held = {}
    for rid in stream_ids:
        p, _, r = got[rid]
        prompt = np.random.default_rng(zlib.crc32(rid.encode())).integers(0, vocab, (p,))
        held[rid] = gaps(prompt.astype(np.int32), r["tokens"])
    return held


def phase_serve(kernels):
    """The serve main path at llama_0_3b's width and ``SERVE_LAYERS`` layers
    through ``workloads.serve.run`` on
    bench.py's engine stream, every emitted token held by teacher forcing;
    then the engine on edge requests, held the same way; then a decode block
    timed. Returns the decode block's profile, to run after every timed
    run."""
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.workloads import generate

    cfg = llama_lib.llama_0_3b(decode=True, max_decode_len=SERVE_KNOBS["max_decode_len"],
                               n_layers=SERVE_LAYERS)
    _, got, stream_ids, launches = _serve_stream("0.3b", cfg)
    _record_launches(kernels, "serve", launches)
    torch.cuda.empty_cache()
    # serve.run's weights (the same seed).
    model, _ = generate.load_params(cfg, config="0.3b", device="cuda", seed=0, log=_log, tag="serve")
    gaps = _teacher_gaps(model)
    _hold_gaps("serve stream", _stream_gaps(gaps, cfg.vocab_size, got, stream_ids))
    engine = _serve_edges(model, gaps)
    return _time_decode_block(engine, f"bf16 0.3b ({SERVE_LAYERS} layers)")[1]


def _serve_edges(model, gaps):
    """Edge requests through one engine on ``model``, every greedy token held
    by teacher forcing (``gaps``); a reading of agreement with the
    single-stream rollout."""
    import numpy as np
    import torch

    from pytorch_operator_tpu_torch.serving import Request, ServingEngine
    from pytorch_operator_tpu_torch.workloads import generate

    cfg, L, chunk = model.cfg, SERVE_KNOBS["max_decode_len"], SERVE_KNOBS["chunk"]
    engine = ServingEngine(cfg, model, slots=SERVE_KNOBS["slots"], chunk=chunk, block=SERVE_KNOBS["block"])
    rng = np.random.default_rng(11)
    shapes = [
        ("one_chunk", chunk, 96),
        ("second_chunk", chunk + 1, 96),
        ("budget_edge", L - 1 - 64, 64),  # p + new = L - 1
        ("single_token", 300, 1),
    ] + [(f"fill{i}", int(rng.integers(64, 1025)), int(rng.integers(16, 129))) for i in range(7)]
    prompts = {name: rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32) for name, p, _ in shapes}
    for name, _, n in shapes:
        engine.submit(Request(name, prompts[name], n, time.time()))
    results = {r.id: r for r in engine.run_until_drained()}
    if sorted(results) != sorted(name for name, _, _ in shapes):
        _fail(f"edge requests answered: {sorted(results)}")
    held, same = {}, 0
    for name, p, n in shapes:
        toks = results[name].tokens
        if len(toks) != n:
            _fail(f"edge request {name}: {len(toks)} tokens of {n}")
        held[name] = gaps(prompts[name], toks)
        with torch.no_grad():
            rollout, _ = generate.make_generate(model, max_new_tokens=n)(
                generate.init_cache(model, 1), torch.from_numpy(prompts[name]).long().cuda()[None],
                torch.Generator("cuda"),
            )
        same += int(rollout[0].tolist() == toks)
        g = held[name]
        _log(f"serve edge {name} (prompt {p}, new {n}): worst gap {float(g.max()):.4f}, "
             f"exact argmax {int((g == 0).sum())}/{n}, equals the rollout {rollout[0].tolist() == toks}")
    _log(f"serve edges: {len(shapes)} requests through {engine.slots} slots; requests equal to "
         f"the single-stream rollout {same}/{len(shapes)}")
    _hold_gaps("serve edges", held)
    torch.cuda.empty_cache()
    return engine


def _time_decode_block(engine, what: str):
    """The admission of 8 prompts of 512 (the first iteration's wall less a
    block's: prefill chunks and first tokens, the TTFT of a request that
    finds a free slot), then one decode block over all 8 slots with the
    profiler off: its wall time, and its peak device memory above what was
    resident before it. Returns ``(readings, profile)``: ``profile()``
    profiles a block of ``PROFILE_STEPS`` steps (the card's busy share a
    step against an unprofiled step, kernel launches a decode
    step, device time by kernel, the host ops that take the most host time)
    and times one after the profiler session; it is to run after every timed
    run."""
    import numpy as np
    import torch

    from pytorch_operator_tpu_torch.ops.quantize import state_bytes
    from pytorch_operator_tpu_torch.serving import Request

    prompt_len = 512
    rng = np.random.default_rng(13)
    for i in range(engine.slots):
        prompt = rng.integers(0, engine.cfg.vocab_size, (prompt_len,)).astype(np.int32)
        engine.submit(Request(f"prof{i}", prompt, 5 * engine.block, time.time()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.step()  # admission and a first block
    first = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine.step()  # one block, no admission
    off = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    chunks = engine.slots * -(-prompt_len // engine.chunk)
    weights = state_bytes(engine._decode_model.state_dict())
    cache = state_bytes({f"{n}.{k}": t for n, d in engine._cache.items() for k, t in d["attn"].items()})
    readings = {"step_ms": 1e3 * off / engine.block, "peak_bytes": peak, "weights": weights, "cache": cache}
    _log(
        f"serve {what}: admission of {engine.slots} prompts of {prompt_len} ({chunks} prefill chunks "
        f"of {engine.chunk}): {1e3 * (first - off):.2f} ms (first iteration {1e3 * first:.2f} ms less "
        f"a block), {1e3 * (first - off) / chunks:.3f} ms a chunk; a decode block "
        f"{1e3 * off:.2f} ms with the profiler off ({readings['step_ms']:.3f} ms a step); resident "
        f"weights {weights / 2**30:.3f} GiB + cache {cache / 2**30:.3f} GiB, peak during the block "
        f"{peak / 2**30:.3f} GiB above the resident"
    )

    def profile():
        from torch.profiler import ProfilerActivity, profile as torch_profile

        # A block of PROFILE_STEPS: the readings a step are the same, and the
        # profiler's post-processing grows with the events it holds.
        block, engine.block = engine.block, PROFILE_STEPS
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.step()
            wall = time.perf_counter() - t0
        engine.block = block
        busy_s, launches = _report_profile(
            prof, wall, f"one {what} decode block ({PROFILE_STEPS} steps x {engine.slots} slots)", top=15
        )
        _log(
            f"serve {what} decode block: {1e3 * off:.2f} ms with the profiler off "
            f"({1e3 * off / block:.3f} ms a step); device busy {1e3 * busy_s / PROFILE_STEPS:.3f} "
            f"ms a step, {100 * busy_s / PROFILE_STEPS / (off / block):.1f}% of an unprofiled step; "
            f"{launches / PROFILE_STEPS:.1f} kernel launches a decode step"
        )
        host = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
        _log(f"host ops of the profiled {what} block by self host time (profiler on):")
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
            _log(f"  host {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:80]}")
        t0 = time.perf_counter()
        engine.step()
        after = time.perf_counter() - t0
        _log(
            f"serve {what} decode block after the profiler session: {1e3 * after:.2f} ms "
            f"({1e3 * after / engine.block:.3f} ms a step; before it {1e3 * off / engine.block:.3f})"
        )
        engine.abort_in_flight()

    return readings, profile


# The int8 serving stack (phase 7): bench.py's decode A/B point
# (bench.py:481-489) and engine point (bench.py:535-549) at llama_1b.
INT8 = dict(quantize="int8", kv_quantize="int8")
# The int8 weights at rest: memory_allocated() above what was resident before
# the load may exceed state_bytes (q, scales, norms) plus the cache by at most
# this much (the allocator rounds each of ~300 tensors up to 512 bytes).
AT_REST_MARGIN = 1 << 20
# The int8 model's logits against a bf16 model on its weights dequantized
# apart: the same kernels on the same values, so the sound reading is 0; a
# weight rounded to a neighbouring bf16 value anywhere moves logits by more.
INT8_WEIGHT_TOL = 1e-4
# kv8 attention against dequantize-then-attend (a plain f32 attention over
# f32(q) * scale): the layer rounds the probabilities to bf16 twice and its
# output once, so the relative L2 error is a few bf16 ulps (2^-8 = 3.9e-3).
KV8_ATTN_RTOL = 1e-2


def phase_int8(kernels):
    """Phase 7, the int8 serving stack at llama_1b's full width and
    ``SERVE_LAYERS`` layers:
    (a) the generate A/B, (b) the int8 weights at rest and the kv8 cache
    against independent references, (c) serve on bench.py's stream, (d)
    every emitted token held by a kv8 teacher, (e) the decode block's time
    and peak memory against the bf16 stack's, and the int8 work of a step.
    Returns the int8 decode block's profile, to run after every timed run."""
    import dataclasses
    import gc

    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.ops import quantize as quant
    from pytorch_operator_tpu_torch.serving import ServingEngine
    from pytorch_operator_tpu_torch.workloads import generate

    n_layers = SERVE_LAYERS
    # (a) bench.py's decode A/B: int8 + kv8 against the bf16 control, same call.
    fa.reset_launch_count()
    result = generate.run(
        config="1b", n_layers=n_layers, batch_size=8, prompt_len=128, max_new_tokens=128,
        max_decode_len=4096,
        compare_unquantized=True, device="cuda", log=_log, **INT8,
    )
    launches = fa.launch_counts()
    _log(f"int8 generate path launches: {launches}")
    _record_launches(kernels, "generate_int8", launches)
    if result["flash_launches_per_generate"] != n_layers:
        _fail(f"flash kernel launched {result['flash_launches_per_generate']} times per int8 "
              f"generate call, expected {n_layers} (one per layer)")
    # run(): 1 + 3 int8 calls and 3 timed prefills, 1 + 3 control calls.
    if launches["flash_fwd"] != 11 * n_layers:
        _fail(f"flash kernel launched {launches['flash_fwd']} times, expected {11 * n_layers}")
    _log(
        f"generate 1b int8 + kv8 ({n_layers} layers, B8, prompt 128, 128 new, L 4096): "
        f"{result['value']} tok/s "
        f"(generate {result['generate_s']:.4f} s), bf16 control {result['tokens_per_sec_per_chip_unquantized']} "
        f"tok/s (generate {result['generate_s_unquantized']:.4f} s), int8_speedup "
        f"{result['int8_speedup']}, weight_mb {result['weight_mb']}, prefill_s {result['prefill_s']:.5f}"
    )
    torch.cuda.empty_cache()

    # (b) The int8 model alone, serve.run's weights (seed 0), at rest:
    # initialised and quantized on the host, as examples/serve.yaml loads it.
    cfg = llama_lib.llama_1b(decode=True, max_decode_len=SERVE_KNOBS["max_decode_len"],
                             n_layers=n_layers, **INT8)
    gc.collect()
    base = torch.cuda.memory_allocated()
    model, _ = generate.load_params(cfg, config="1b", device="cuda", quantize="int8", init_host=True,
                                    seed=0, log=_log, tag="serve")
    sd = model.state_dict()
    for name, t in sd.items():
        held = quant.is_quantized(name)
        if not t.is_cuda or (held and t.dtype != torch.int8) or (
            not held and t.dtype != torch.float32
        ):
            _fail(f"int8 model entry {name}: {t.dtype} on {t.device}")
    weights = quant.state_bytes(sd)
    resident = torch.cuda.memory_allocated() - base
    _log(f"int8 1b at rest: {resident} bytes allocated, state_bytes {weights} (margin "
         f"{AT_REST_MARGIN}); the bf16 serving model's weights: {_bf16_bytes(sd)} bytes")
    if resident > weights + AT_REST_MARGIN:
        _fail("the int8 model holds more than its int8 state on the card")
    direct, _ = generate.load_params(cfg, config="1b", device="cuda", quantize="int8", seed=0,
                                     log=_log, tag="serve")
    differ = [n for n, t in direct.state_dict().items() if not torch.equal(t, sd[n])]
    _log(f"int8 1b state from --init-host against the one quantized on the card (seed 0): "
         f"{len(differ)} of {len(sd)} entries differ")
    if differ:
        _fail(f"--init-host and the card's init give other int8 weights for one seed: {differ[:4]}")
    del direct
    _int8_weight_check(model)
    _kv8_checks(model)
    knobs = {k: SERVE_KNOBS[k] for k in ("slots", "chunk", "block")}
    engine = ServingEngine(cfg, model, **knobs)
    resident = torch.cuda.memory_allocated() - base
    cache = sum(t.numel() * t.element_size() for d in engine._cache.values() for t in d["attn"].values())
    _log(f"int8 1b engine resident: {resident} bytes allocated, state_bytes + cache {weights + cache}")
    if resident > weights + cache + AT_REST_MARGIN:
        _fail("the int8 engine holds more than its int8 state and its cache on the card")

    # (c) bench.py's engine point.
    _, got, stream_ids, launches = _serve_stream("1b", cfg, **INT8)
    _record_launches(kernels, "serve_int8", launches)
    torch.cuda.empty_cache()

    # (d) Every stream token held by the kv8 teacher on the same int8
    # weights; beside it (no gate) the bf16 dense model on the unquantized
    # seed weights: the quantization's cost on random weights.
    _hold_gaps("int8 serve stream (kv8 teacher)", _stream_gaps(_kv8_teacher_gaps(model), cfg.vocab_size,
                                                              got, stream_ids))
    fp_cfg = dataclasses.replace(cfg, quantize=None, kv_quantize=None)
    fp, _ = generate.load_params(fp_cfg, config="1b", device="cuda", seed=0, log=_log, tag="serve")
    fp_gaps = _stream_gaps(_teacher_gaps(fp), cfg.vocab_size, got, stream_ids)
    every = torch.cat(list(fp_gaps.values()))
    _log(
        f"int8 serve stream against the bf16 dense model on the unquantized weights (no gate): "
        f"{len(every)} tokens, exact argmax share {float((every == 0).float().mean()):.4f}, worst gap "
        f"{float(every.max()):.4f}, mean gap {float(every.mean()):.4f}"
    )

    # (e) The decode block, int8 + kv8 against bf16 at 1b, then the int8
    # work of one decode step on its own.
    int8_block, profile = _time_decode_block(engine, f"int8 + kv8 1b ({n_layers} layers)")
    bf16_engine = ServingEngine(fp_cfg, fp, **knobs)
    bf16_block, _ = _time_decode_block(bf16_engine, f"bf16 1b ({n_layers} layers)")
    bf16_engine.abort_in_flight()
    del bf16_engine, fp
    _log(
        f"decode block at 1b ({n_layers} layers): int8 + kv8 {int8_block['step_ms']:.3f} ms a step, bf16 "
        f"{bf16_block['step_ms']:.3f} ms; resident int8 {(int8_block['weights'] + int8_block['cache']) / 2**30:.3f} "
        f"GiB, bf16 {(bf16_block['weights'] + bf16_block['cache']) / 2**30:.3f} GiB; peak above it "
        f"int8 {int8_block['peak_bytes'] / 2**30:.3f} GiB, bf16 {bf16_block['peak_bytes'] / 2**30:.3f} GiB"
    )
    _time_int8_work(model, engine)
    torch.cuda.empty_cache()
    return profile


def _bf16_bytes(sd) -> int:
    """Bytes of the state dict's weights held in bf16 (norms and head f32),
    the bf16 serving model's at rest."""
    from pytorch_operator_tpu_torch.ops.quantize import is_quantized

    return sum(
        t.numel() * (2 if is_quantized(n) and n != "lm_head.weight" else 4)
        for n, t in sd.items() if not n.endswith(".scale")
    )


def _int8_weight_check(model, B: int = 2, S: int = 256):
    """The int8 weight path against a reference that does not run it: a
    bf16 model on weights dequantized here, ``bf16(f32(q) * scale)`` (the
    head ``f32(q) * scale``), and the int8 model, both dense full forwards
    over the same B prompts of S. They run the same kernels on the same
    values, so their logits must agree within INT8_WEIGHT_TOL."""
    import dataclasses

    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib

    sd = model.state_dict()
    ref_sd = {}
    for name, t in sd.items():
        scale = name[: -len("weight")] + "scale"
        if name.endswith(".scale"):
            continue
        if scale in sd:
            t = t.float() * sd[scale]
            if name != "lm_head.weight":
                t = t.to(model.cfg.dtype)
        ref_sd[name] = t
    cfg = dataclasses.replace(model.cfg, decode=False, decode_per_row=False, prefill_mode="self",
                              attn_impl="dense", kv_quantize=None)
    int8 = llama_lib.Llama(cfg, device="meta")
    int8.load_state_dict(sd, assign=True)
    ref = llama_lib.Llama(dataclasses.replace(cfg, quantize=None), device="meta")
    ref.load_state_dict(ref_sd, assign=True)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(8))
    with torch.no_grad():
        got, want = int8(tokens), ref(tokens)
    err = float((got - want).abs().max())
    _log(f"int8 weight path, 1b full forward (B{B}, S{S}): logits within {err:.3e} of the bf16 model on "
         f"weights dequantized apart (largest |logit| {float(want.abs().max()):.3f}; tol {INT8_WEIGHT_TOL:.0e})")
    if not err <= INT8_WEIGHT_TOL:
        _fail("the int8 weight path disagrees with the model on its dequantized weights")
    del int8, ref, ref_sd, got, want
    torch.cuda.empty_cache()


def _kv8_checks(model, B: int = 8, S: int = 512):
    """The kv8 cache against references that do not run its code: a
    chunked prefill of B prompts of S through the int8 model with an int8
    cache and with a bf16 one; layer 0's K/V inputs are the same in both, so
    its dequantized int8 slabs must lie within scale/2 of the bf16 slabs;
    then layer 0's cache attention of the last position over the int8 cache
    against a plain f32 attention over the dequantized slabs."""
    import dataclasses

    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib

    cfg = dataclasses.replace(model.cfg, prefill_mode="cache")
    caches = {}
    prompt = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(5))
    for kv in ("int8", None):
        m = llama_lib.Llama(dataclasses.replace(cfg, kv_quantize=kv), device="meta")
        m.load_state_dict(model.state_dict(), assign=True)
        caches[kv] = llama_lib.init_decode_cache(m.cfg, B, device="cuda")
        with torch.no_grad():
            llama_lib.decode_forward(m, caches[kv], prompt, torch.arange(S, device="cuda").expand(B, S))
    c8, c16 = caches["int8"]["layer_0"]["attn"], caches[None]["layer_0"]["attn"]
    worst = 0.0
    for slab, scale in (("cached_key", "key_scale"), ("cached_value", "value_scale")):
        deq = c8[slab][:, :, :S].float() * c8[scale][:, :, :S]
        err = (deq - c16[slab][:, :, :S].float()).abs() / c8[scale][:, :, :S]
        worst = max(worst, float(err.max()))
    _log(f"kv8 write, layer 0 (B{B}, S{S}): |dequantized - bf16| at most {worst:.4f} of a scale (tol 0.5)")
    if not worst <= 0.5 + 1e-3:
        _fail("the kv8 cache does not hold its tokens' K/V within half a scale")
    attn = model.layers[0].attn
    H, D = cfg.n_heads, cfg.head_dim
    q = torch.randn((B, 1, H, D), device="cuda", generator=torch.Generator("cuda").manual_seed(6))
    q = q.to(cfg.dtype)
    pos = torch.full((B, 1), S - 1, device="cuda")
    with torch.no_grad():
        got = attn._cache_attend(q, pos, c8).float()  # [B, 1, H, D]
    K = cfg.n_kv_heads
    kd = (c8["cached_key"][:, :, :S].float() * c8["key_scale"][:, :, :S])  # [B, K, S, D]
    vd = (c8["cached_value"][:, :, :S].float() * c8["value_scale"][:, :, :S])
    qg = q.float().view(B, 1, K, H // K, D)
    probs = torch.softmax(torch.einsum("bskgd,bktd->bkgst", qg, kd) / math.sqrt(D), dim=-1)
    ref = torch.einsum("bkgst,bktd->bskgd", probs, vd).reshape(B, 1, H, D)
    rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
    _log(f"kv8 cache attention, layer 0 (B{B}, {S} cached tokens): relative L2 error "
         f"{rel:.3e} against dequantize-then-attend (tol {KV8_ATTN_RTOL:.0e})")
    if not rel <= KV8_ATTN_RTOL:
        _fail("the kv8 cache attention disagrees with dequantize-then-attend")
    del caches
    torch.cuda.empty_cache()


def _kv8_teacher_gaps(model):
    """Teacher forcing on ``model``'s int8 weights with an int8 cache: a
    batch-1 decode model with ``prefill_mode="cache"`` run over prompt and
    emitted tokens in one chunk, which quantizes the cache per token and kv
    head as the engine's writes do. Returns ``gaps(prompt, tokens)`` as
    :func:`_teacher_gaps` does."""
    import dataclasses

    import numpy as np
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib

    cfg = dataclasses.replace(model.cfg, decode=True, decode_per_row=False, prefill_mode="cache")
    teacher = llama_lib.Llama(cfg, device="meta")
    teacher.load_state_dict(model.state_dict(), assign=True)
    head = teacher.head_kernel()
    # One cache for every request: positions [0, n) are rewritten and the
    # col <= row mask hides the rest.
    cache = llama_lib.init_decode_cache(cfg, 1, device="cuda")

    @torch.no_grad()
    def gaps(prompt, toks):
        p, n = len(prompt), len(toks)
        seq = torch.from_numpy(np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])).long().cuda()
        hidden, _ = llama_lib.decode_forward(
            teacher, cache, seq[None], torch.arange(len(seq), device="cuda")[None]
        )
        logits = hidden[0, p - 1 :].float() @ head  # [n, V]
        chosen = logits[torch.arange(n), torch.tensor(toks, device="cuda")]
        return (logits.max(-1).values - chosen).cpu()

    return gaps


def _time_int8_work(model, engine):
    """Device time of one decode step's int8 work outside the matmuls, each
    against the bytes it must move: the dequantization of every layer weight
    (int8 and scale read, bf16 written) and of the head (f32 written), and
    the kv8 write of one token a slot into every layer's cache (quantize,
    then four per-row writes), on a scratch copy of one layer's cache."""
    import torch

    from pytorch_operator_tpu_torch.ops import quantize as quant

    mods = [m for m in model.modules() if getattr(m, "scale", None) is not None]
    layer = [(m.weight, m.scale) for m in mods if m is not model.embed and m is not model.lm_head]
    head = model.lm_head
    n_w = sum(w.numel() for w, _ in layer)
    dq_ms = _time_ms(lambda: [quant.dequantize(w, s, torch.bfloat16) for w, s in layer], reps=5)
    head_ms = _time_ms(lambda: quant.dequantize(head.weight, head.scale, torch.float32), reps=5)
    dq_bytes = 3 * n_w + sum(4 * s.numel() for _, s in layer)
    head_bytes = 5 * head.weight.numel() + 4 * head.scale.numel()
    attn = engine._decode_model.layers[0].attn
    cfg = attn.cfg
    B, K, D = engine.slots, cfg.n_kv_heads, cfg.head_dim
    scratch = {k: t.clone() for k, t in engine._cache["layer_0"]["attn"].items()}
    gen = torch.Generator("cuda").manual_seed(7)
    k, v = (torch.randn((B, 1, K, D), device="cuda", generator=gen).to(cfg.dtype) for _ in range(2))
    pos = torch.arange(B, device="cuda")[:, None] + 600
    # Two reps: ~370 small launches each, which the host enqueues within the
    # sleep _time_ms puts ahead of them (more would time the host).
    write_ms = _time_ms(
        lambda: [attn.write_cache(k, v, pos, scratch) for _ in range(cfg.n_layers)], reps=2
    )
    del scratch
    _log(
        f"int8 work of one 1b decode step (device time, CUDA events): dequantize {len(layer)} layer "
        f"weights ({n_w / 1e9:.3f} B) {dq_ms:.4f} ms, {dq_bytes / dq_ms / 1e6:.1f} GB/s (bound "
        f"{1e3 * dq_bytes / HBM_BYTES_PER_S:.4f} ms); the head {head_ms:.4f} ms (bound "
        f"{1e3 * head_bytes / HBM_BYTES_PER_S:.4f} ms); kv8 write of {B} tokens into "
        f"{cfg.n_layers} layers {write_ms:.4f} ms"
    )


# Phase 8, the journey: bench.py's real-data leg (bench.py:307-391) on the
# port. The corpus is the repo's own bytes, byte-level (vocab 256 of the
# 32,000-entry 0.3b vocabulary), records of 1024 tokens.
# The journey runs at SERVE_LAYERS: its checkpoints (1.9 GB a step at 8
# layers, 3.8 GB at 16) are written, read and copied on TMPDIR's disk, whose
# rate the script does not choose. 40 steps, with saves at 40 and 42.
JOURNEY_S = 1024
JOURNEY_TRAIN = dict(
    config="0.3b", n_layers=SERVE_LAYERS, batch_size=16, seq_len=JOURNEY_S, steps=40, warmup=2,
    eval_batches=4, lr=3e-4, lr_schedule="cosine", lr_warmup_steps=8, grad_clip=1.0, remat=True,
    remat_policy="dots", donate=True, checkpoint_every=40,
)
# The saved steps: the periodic save and the run's end.
JOURNEY_SAVED = (JOURNEY_TRAIN["checkpoint_every"], JOURNEY_TRAIN["warmup"] + JOURNEY_TRAIN["steps"])
JOURNEY_QUALITY = dict(
    config="0.3b", n_layers=SERVE_LAYERS, eval_batches=2, batch_size=8, chunk=128, drift_tokens=256,
    drift_window=128, drift_prompt=128,
)
# Held-out loss below chance (ln 256 = 5.545) less one nat: bench.py's
# ``learned``.
LEARNED_BELOW = math.log(256) - 1.0
# One step with remat against one without, on the same weights and batch:
# the forward is the same launches in the same order, and the backward
# recomputes each block's forward from the same inputs with the same
# kernels, so both should be exact; a reordered f32 sum would move the mean
# loss by ~1e-7 and the global norm (0.3 B f32 squares) by far less than a
# bf16 ulp (2^-8 = 3.9e-3), the bounds held here.
REMAT_LOSS_RTOL = 1e-5
REMAT_GRAD_NORM_RTOL = 1e-3
# The fp serving path (bf16 cache attention, f32 logits, F.cross_entropy)
# against the training path (flash kernel, chunked loss) on the same trained
# weights and rows: both round bf16 at other points, which the layers carry
# into each position's loss; the mean over 16 x 1023 positions is held here,
# unrounded. On trained weights the two lie 2.8e-5 to 7.8e-5 apart, either
# way (PERF.md); the limit is about four times that, and _serving_faults'
# gated fault must fail it.
SERVE_TRAIN_LOSS_TOL = 3e-4
# Flash launches a step of the 0.3b model: each block once in the forward,
# once more in the remat recompute; each backward kernel once a block.
def _per_step(n_layers: int, remat: bool) -> dict:
    return {"flash_fwd": (2 if remat else 1) * n_layers, "flash_bwd_dq": n_layers,
            "flash_bwd_dkv": n_layers}


def _journey_corpus(td):
    """bench.py's corpus (bench.py:322-342): the bytes of the JAX package's
    sources and the root ``*.md`` files, sorted, cut into records of
    ``JOURNEY_S`` bytes, permuted with ``default_rng(0)``, split 90/10 and
    packed with the port's ``pack_arrays``. Returns (train, eval) paths and
    the held-out records."""
    import glob
    from pathlib import Path

    import numpy as np

    from pytorch_operator_tpu_torch.data import pack_arrays

    root = Path(__file__).resolve().parent
    paths = sorted(glob.glob(str(root / "pytorch_operator_tpu/**/*.py"), recursive=True)) + sorted(
        glob.glob(str(root / "*.md"))
    )
    data = b"".join(Path(p).read_bytes() for p in paths)
    n = len(data) // JOURNEY_S
    arr = np.frombuffer(data[: n * JOURNEY_S], np.uint8).astype(np.int32).reshape(n, JOURNEY_S)
    arr = arr[np.random.default_rng(0).permutation(n)]
    split = max(16, int(n * 0.9))
    train_f, eval_f = Path(td) / "train.bin", Path(td) / "eval.bin"
    pack_arrays(train_f, {"tokens": arr[:split]})
    pack_arrays(eval_f, {"tokens": arr[split:]})
    _log(f"journey corpus: {len(paths)} files, {len(data):,} bytes, {n} records of {JOURNEY_S}: "
         f"{split} for training, {n - split} held out")
    return str(train_f), str(eval_f), arr[split:]


def _eval_rows(eval_f: str, batch: int, batches: int):
    """The held-out rows that a loader of ``eval_f`` with seed 1 yields first
    (what llama_train's eval and quality_eval read), copied out of the slot."""
    import numpy as np

    from pytorch_operator_tpu_torch.data import open_loader

    loader = open_loader(eval_f, batch, seed=1)
    try:
        return np.concatenate(
            [np.array(loader.next_batch()[2]["tokens"], np.int32, copy=True) for _ in range(batches)]
        )
    finally:
        loader.close()


def phase_journey(kernels):
    """Phase 8: train -> checkpoint -> serve on the repo's own text, at
    llama_0_3b full width and ``SERVE_LAYERS`` layers. (a) the corpus; (b)
    bench.py's training call through the native loader with remat ``dots``;
    (c) the checkpoints ``JOURNEY_SAVED``, restored bit for bit, and a planted corrupt step
    caught; the remat A/B; (d) quality_eval on the checkpoint; (e) generate
    and serve on the restored weights, every served token teacher-forced.
    Returns the profile of one remat training step, to run last."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager, integrity
    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import llama_train, quality_eval

    n_layers = JOURNEY_TRAIN["n_layers"]
    td = tempfile.mkdtemp(prefix="chip_smoke_journey_")
    try:
        train_f, eval_f, held_out = _journey_corpus(td)
        ck = os.path.join(td, "ck")

        # (b) Training, as bench.py calls it, with the supervisor's
        # checkpoint directory set for the call only.
        prev = os.environ.get("TPUJOB_CHECKPOINT_DIR")
        os.environ["TPUJOB_CHECKPOINT_DIR"] = ck
        resident = torch.cuda.memory_allocated()
        fa.reset_launch_count()
        t0 = time.perf_counter()
        try:
            r = llama_train.run(data_file=train_f, eval_file=eval_f, device="cuda", log=_log,
                                **JOURNEY_TRAIN)
        finally:
            if prev is None:
                os.environ.pop("TPUJOB_CHECKPOINT_DIR", None)
            else:
                os.environ["TPUJOB_CHECKPOINT_DIR"] = prev
        wall = time.perf_counter() - t0
        launches = fa.launch_counts()
        _log(f"journey training path launches: {launches}")
        _record_launches(kernels, "journey_train", launches)
        steps = JOURNEY_TRAIN["warmup"] + JOURNEY_TRAIN["steps"]
        want = _per_step(n_layers, remat=True)
        eval_fwd = n_layers * JOURNEY_TRAIN["eval_batches"]
        if r["flash_launches_per_step"] != want or launches != {
            "flash_fwd": want["flash_fwd"] * steps + eval_fwd,
            "flash_bwd_dq": want["flash_bwd_dq"] * steps,
            "flash_bwd_dkv": want["flash_bwd_dkv"] * steps,
        }:
            _fail(f"journey training launched {launches} ({r['flash_launches_per_step']} a step), "
                  f"expected {want} a step over {steps} steps and {eval_fwd} forwards of the eval")
        learned = r.get("eval_loss") is not None and r["eval_loss"] < LEARNED_BELOW
        _log(
            f"journey train 0.3b ({n_layers} layers, B16 x S1024, remat dots, {steps} steps, native "
            f"loader): "
            f"{r['value']} tokens/s, step {r['step_s']:.4f} s, peak memory "
            f"{r['peak_mem_bytes'] / 2**30:.2f} GiB ({resident / 2**30:.2f} GiB of it resident "
            f"before the call), final_loss {r['final_loss']}, eval_loss "
            f"{r.get('eval_loss')} (ppl {r.get('eval_perplexity')}), loader {r.get('loader')}, learned "
            f"{learned} (eval_loss < {LEARNED_BELOW:.3f}); the call's wall {wall:.1f} s; first "
            f"losses {[round(x, 3) for x in r['losses'][:4]]}, last {round(r['losses'][-1], 4)}"
        )
        if r.get("loader") != "native":
            _fail(f"journey training ran the {r.get('loader')} loader, not the native one")
        if not learned or not all(math.isfinite(x) for x in r["losses"]):
            _fail("journey training did not learn: eval_loss not below chance less one nat")
        torch.cuda.empty_cache()

        # (c) The checkpoints.
        cfg = llama_lib.llama_0_3b(n_layers=n_layers)
        fresh = llama_lib.Llama(cfg, device="cuda")
        opt = _journey_restore(ck, fresh, eval_f, r)
        _journey_planted_fault(ck, td, fresh, opt)
        del opt
        torch.cuda.empty_cache()
        _journey_remat_step(fresh, held_out)
        del fresh
        torch.cuda.empty_cache()
        _journey_remat_ab(train_f)

        # (d) Quality through the serving path.
        fa.reset_launch_count()
        q = quality_eval.run(restore=ck, eval_file=eval_f, device="cuda", log=_log, **JOURNEY_QUALITY)
        launches = fa.launch_counts()
        _log(f"journey quality path launches: {launches}")
        _record_launches(kernels, "journey_quality", launches)
        if launches["flash_fwd"] != n_layers or launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]:
            _fail(f"quality_eval launched {launches}: expected the rollout's one prefill")
        _log(
            f"journey quality (restored step {q['restored_step']}, {q['eval_rows']} held-out rows of "
            f"{q['eval_seq_len']}): fp {q['fp_eval_loss']}, int8 {q['int8_eval_loss']}, int8_kv8 "
            f"{q['int8_kv8_eval_loss']}; int8_loss_delta {q['int8_loss_delta']}, int8_kv8_loss_delta "
            f"{q['int8_kv8_loss_delta']}; argmax agreement int8 {q['int8_eval_argmax_agreement']}, "
            f"int8_kv8 {q['int8_kv8_eval_argmax_agreement']}; drift {json.dumps(q['drift'])}; greedy fp "
            f"rollout of {JOURNEY_QUALITY['drift_tokens']} tokens {q['drift_rollout_s']} s"
        )
        if not all(math.isfinite(q[f"{v}_eval_loss"]) for v in ("fp", "int8", "int8_kv8")):
            _fail("quality_eval losses not finite")
        _journey_serve_vs_train(ck, eval_f, q)
        torch.cuda.empty_cache()

        # (e) Serving the trained weights.
        _journey_generate(kernels, ck, held_out)
        _journey_serve(kernels, ck, held_out)
    finally:
        shutil.rmtree(td, ignore_errors=True)
    return _profile_journey_step


def _journey_restore(ck, fresh, eval_f, r):
    """The steps ``JOURNEY_SAVED`` committed with their sidecars, the newest
    verified the last; it restored into a fresh model and optimizer on the card equals
    the checkpoint's tensors bit for bit, and evaluates to the run's
    ``eval_loss`` on the same held-out batches. Returns the optimizer."""
    import os

    import torch

    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager, integrity
    from pytorch_operator_tpu_torch.workloads import trainer

    first, last = JOURNEY_SAVED
    steps = integrity.list_steps(ck)
    sidecars = sorted(n for n in os.listdir(ck) if n.endswith(".digest"))
    mgr = CheckpointManager(ck, create=False)
    verified = mgr.latest_verified_step()
    last_dir = os.path.join(ck, str(last))
    sizes = {n: os.path.getsize(os.path.join(last_dir, n)) for n in sorted(os.listdir(last_dir))}
    _log(f"journey checkpoints: steps {steps}, sidecars {sidecars}, latest verified {verified}; "
         f"step {last} files {sizes}")
    if steps != [first, last] or sidecars != sorted([f"{first}.digest", f"{last}.digest"]) or verified != last:
        _fail(f"the journey's checkpoints are not steps {first} and {last}, both verified")
    opt = trainer.make_optimizer(fresh.parameters(), 3e-4)
    t0 = time.perf_counter()
    step, state = mgr.restore_or_none({"params": fresh.state_dict(), "opt_state": opt.state_dict()})
    fresh.load_state_dict(state["params"])
    opt.load_state_dict(state["opt_state"])
    restore_s = time.perf_counter() - t0
    differ = [n for n, t in state["params"].items() if not torch.equal(fresh.state_dict()[n].cpu(), t)]
    moments = opt.adamw.state_dict()["state"]
    saved = state["opt_state"]["adamw"]["state"]
    differ += [f"opt {i} {k}" for i, st in saved.items() for k, t in st.items()
               if not torch.equal(moments[i][k].cpu(), t)]
    rows = _eval_rows(eval_f, JOURNEY_TRAIN["batch_size"], JOURNEY_TRAIN["eval_batches"])
    eval_step = trainer.make_lm_eval_step(fresh)
    losses = [float(eval_step(torch.from_numpy(b).cuda().long()))
              for b in rows.reshape(JOURNEY_TRAIN["eval_batches"], JOURNEY_TRAIN["batch_size"], -1)]
    eval_loss = sum(losses) / len(losses)
    _log(f"journey restore of step {step} into a fresh model and AdamW ({restore_s:.2f} s): count "
         f"{opt.count}, {len(differ)} tensors differ from the checkpoint; eval loss of the restored "
         f"model {eval_loss:.6f} against the run's {r['eval_loss']}")
    if step != last or differ or opt.count != last or round(eval_loss, 4) != r["eval_loss"]:
        _fail(f"the restored step {last} is not the trained model")
    return opt


def _journey_planted_fault(ck, td, fresh, opt):
    """In a copy of the checkpoint directory, ``corrupt_step`` on the last
    saved step: the restore must fall back to the first and report
    ``checkpoint_corrupt``; the original last step must still verify."""
    import json as json_
    import os
    import shutil

    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager, integrity

    first, last = JOURNEY_SAVED
    copy = os.path.join(td, "ck_copy")
    # Hard links for what corrupt_step leaves alone, a real copy of the file
    # it damages (the largest of the last step: the AdamW moments).
    shutil.copytree(ck, copy, copy_function=os.link)
    victim = os.path.join(copy, str(last), "opt_state.pt")
    os.unlink(victim)
    shutil.copyfile(os.path.join(ck, str(last), "opt_state.pt"), victim)
    damaged = integrity.corrupt_step(copy, last)
    status = os.path.join(td, "status")
    os.makedirs(status)
    env = {"TPUJOB_STATUS_DIR": status, "TPUJOB_REPLICA_TYPE": "Master", "TPUJOB_REPLICA_INDEX": "0"}
    prev = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        got = CheckpointManager(copy, create=False).restore_or_none(
            {"params": fresh.state_dict(), "opt_state": opt.state_dict()}
        )
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    path = os.path.join(status, "master-0.jsonl")
    recs = [json_.loads(x) for x in open(path).read().splitlines()] if os.path.exists(path) else []
    corrupt = [(x["step"], x["fallback"]) for x in recs if x["event"] == "checkpoint_corrupt"]
    original = integrity.verify_step(ck, last)
    _log(f"journey planted fault: corrupt_step(copy, {last}) flipped a byte of "
         f"{os.path.basename(str(damaged))}; restore_or_none fell back to step "
         f"{None if got is None else got[0]}, checkpoint_corrupt records {corrupt}; the original "
         f"step {last} verifies {original}")
    if got is None or got[0] != first or corrupt != [(last, first)] or original is not True:
        _fail("the planted corrupt step was not caught")
    shutil.rmtree(copy, ignore_errors=True)


def _journey_remat_step(model, held_out):
    """One step's loss and global gradient norm with remat off, ``dots``
    and ``full``, on the trained weights and one held-out batch."""
    import dataclasses

    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.workloads import trainer

    toks = torch.from_numpy(held_out[:16]).cuda().long()
    out = {}
    for name, over in (("off", dict(remat=False)), ("dots", dict(remat=True, remat_policy="dots")),
                       ("full", dict(remat=True, remat_policy="full"))):
        view = llama_lib.Llama(dataclasses.replace(model.cfg, **over), device="meta")
        view.load_state_dict(model.state_dict(), assign=True)
        view.train()
        loss = trainer.make_lm_loss_fn(view)(toks)
        loss.backward()
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad) for p in view.parameters()])
        )
        out[name] = (float(loss.detach()), float(norm))
        view.zero_grad(set_to_none=True)
        del view, loss
    (l0, g0) = out["off"]
    for name in ("dots", "full"):
        l1, g1 = out[name]
        dl, dg = abs(l1 - l0) / abs(l0), abs(g1 - g0) / g0
        _log(f"journey remat {name} against off, one step on the trained weights (B16 x S1024): loss "
             f"{l1:.6f} vs {l0:.6f} (rel {dl:.2e}, tol {REMAT_LOSS_RTOL:.0e}); grad norm {g1:.6f} vs "
             f"{g0:.6f} (rel {dg:.2e}, tol {REMAT_GRAD_NORM_RTOL:.0e})")
        if not (dl <= REMAT_LOSS_RTOL and dg <= REMAT_GRAD_NORM_RTOL):
            _fail(f"remat {name} changes the training step")
    torch.cuda.empty_cache()


def _journey_remat_ab(train_f):
    """What each remat policy costs on this card: llama_train.run at the
    journey's shape, 2 warmup + 3 timed steps of the same data, with remat
    off, ``full`` and ``dots``; flash launches a step checked for each."""
    import torch

    from pytorch_operator_tpu_torch.workloads import llama_train

    kw = {k: JOURNEY_TRAIN[k] for k in ("config", "n_layers", "batch_size", "seq_len", "lr")}
    n_layers = kw["n_layers"]
    for name, over in (("off", {}), ("full", dict(remat=True, remat_policy="full")),
                       ("dots", dict(remat=True, remat_policy="dots"))):
        resident = torch.cuda.memory_allocated()
        r = llama_train.run(steps=3, warmup=2, data_file=train_f, device="cuda", log=lambda m: None,
                            **kw, **over)
        _log(f"journey remat A/B {name}: {r['value']} tokens/s, step {r['step_s']:.4f} s, peak memory "
             f"{r['peak_mem_bytes'] / 2**30:.2f} GiB ({resident / 2**30:.2f} GiB resident before), "
             f"flash launches a step {r['flash_launches_per_step']}")
        if r["flash_launches_per_step"] != _per_step(n_layers, remat=name != "off"):
            _fail(f"remat {name}: flash launches a step {r['flash_launches_per_step']}")
        torch.cuda.empty_cache()


def _journey_serve_vs_train(ck, eval_f, q):
    """The fp serving-path loss against the training path's forward (flash
    kernel, chunked loss) on the same restored weights and held-out rows,
    within SERVE_TRAIN_LOSS_TOL: the serving pass is quality_eval's fp one,
    rerun for its unrounded loss. Then the serving pass under each planted
    numerics fault of :func:`_serving_faults`: those marked so must fail
    the check, the others show what it cannot see."""
    import torch

    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager
    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.workloads import generate, quality_eval, trainer

    rows = _eval_rows(eval_f, JOURNEY_QUALITY["batch_size"], JOURNEY_QUALITY["eval_batches"])
    tokens = torch.from_numpy(rows).cuda().long()
    _, params = CheckpointManager(ck, create=False).restore_subtree("params")
    model = llama_lib.Llama(llama_lib.llama_0_3b(n_layers=JOURNEY_TRAIN["n_layers"]), device="cuda")
    model.load_state_dict(params)
    loss = float(trainer.make_lm_eval_step(model)(tokens))
    del model, params
    # quality_eval's cache length, so that its fp pass is the one rerun here.
    L = max(rows.shape[1], JOURNEY_QUALITY["drift_prompt"] + JOURNEY_QUALITY["drift_tokens"])
    cfg = llama_lib.llama_0_3b(decode=True, max_decode_len=L, n_layers=JOURNEY_TRAIN["n_layers"])
    served, *_ = generate.load_params(cfg, config="0.3b", device="cuda", restore=ck, log=_log,
                                      tag="quality")
    sd = served.state_dict()

    def serving_loss():
        return quality_eval.eval_serving_stream(cfg, sd, tokens, chunk=JOURNEY_QUALITY["chunk"])[0]

    sound = serving_loss()
    diff = abs(sound - loss)
    _log(f"journey serving path against training path, same weights and {len(rows)} rows: fp serving "
         f"loss {sound:.7f} (quality_eval's {q['fp_eval_loss']}) vs training forward {loss:.7f} (diff "
         f"{diff:.2e}, tol {SERVE_TRAIN_LOSS_TOL:.0e})")
    if not abs(sound - q["fp_eval_loss"]) <= 5.1e-5:
        _fail("the serving pass rerun disagrees with quality_eval's fp loss at its 4 decimals")
    if not diff <= SERVE_TRAIN_LOSS_TOL:
        _fail("the serving path's loss disagrees with the training path's on trained weights")
    missed = []
    for name, fault, must_fail in _serving_faults(quality_eval):
        with fault:
            d = abs(serving_loss() - loss)
        _log(f"journey planted serving fault ({name}): diff {d:.2e} from the training path "
             f"({'must exceed' if must_fail else 'ungated, against'} tol {SERVE_TRAIN_LOSS_TOL:.0e})")
        if must_fail and not d > SERVE_TRAIN_LOSS_TOL:
            missed.append(name)
    del served, sd
    if missed:
        _fail(f"the serving-vs-training check misses planted faults: {missed}")


def _serving_faults(quality_eval):
    """Numerics faults planted in the serving pass, one at a time, as
    ``(name, context manager, whether the check must catch it)``: each
    rounds one f32 input of the fp serving path to bf16. On that pass the
    rotary embedding alone calls ``torch.cos``/``sin`` and ``_cache_attend``
    alone ``torch.softmax``. A single bf16 rounding of the logits or the
    scores moves the loss by about as much as the two paths differ, so the
    check cannot see those; rotary angles in bf16 (positions past 256 lose
    their integer step) it must."""
    import types
    from unittest import mock

    import torch
    import torch.nn.functional as F

    def bf16_in(fn):
        return lambda t, *a, **kw: fn(t.to(torch.bfloat16).float(), *a, **kw)

    return [
        ("the rotary angles rounded to bf16", mock.patch.multiple(
            torch, cos=bf16_in(torch.cos), sin=bf16_in(torch.sin)), True),
        ("logits rounded to bf16 before the cross-entropy", mock.patch.object(
            quality_eval, "F", types.SimpleNamespace(cross_entropy=bf16_in(F.cross_entropy))), False),
        ("attention scores rounded to bf16 before the softmax",
         mock.patch.object(torch, "softmax", bf16_in(torch.softmax)), False),
    ]


def _bytes_text(toks) -> str:
    return bytes(int(t) for t in toks if 0 <= t < 256).decode("utf-8", "replace")


def _journey_generate(kernels, ck, held_out):
    """``generate.run(restore=...)`` bf16, then int8 + kv8 (the entry point
    on its random prompts), then each model's greedy continuation of a
    held-out prompt, printed as bytes."""
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import generate

    n_layers, last = JOURNEY_TRAIN["n_layers"], JOURNEY_SAVED[1]
    prompt = torch.from_numpy(held_out[0:1, :256]).cuda().long()
    for name, kw in (("bf16", {}), ("int8 + kv8", INT8)):
        fa.reset_launch_count()
        r = generate.run(config="0.3b", n_layers=n_layers, batch_size=8, prompt_len=256,
                         max_new_tokens=64, restore=ck, device="cuda", log=_log, **kw)
        launches = fa.launch_counts()
        _record_launches(kernels, f"journey_generate_{'bf16' if not kw else 'int8'}", launches)
        _log(f"journey generate --restore {name}: restored_step {r['restored_step']}, {r['value']} tok/s, "
             f"prefill_s {r['prefill_s']:.5f}, launches {launches}")
        if r["restored_step"] != last or launches["flash_fwd"] != 7 * n_layers:
            _fail(f"generate --restore {name}: restored_step {r['restored_step']}, launches {launches}")
        cfg = llama_lib.llama_0_3b(decode=True, max_decode_len=256 + 192, n_layers=n_layers, **kw)
        model, _, _ = generate.load_params(cfg, config="0.3b", device="cuda", restore=ck, log=_log, **(
            {"quantize": "int8"} if kw else {}))
        toks, _ = generate.make_generate(model, max_new_tokens=192)(
            generate.init_cache(model, 1), prompt, torch.Generator("cuda")
        )
        _log(f"journey generate {name}, held-out prompt {_bytes_text(held_out[0, 192:256])!r} -> "
             f"{_bytes_text(toks[0].tolist())!r}")
        del model
        torch.cuda.empty_cache()


def _journey_serve(kernels, ck, held_out):
    """``serve.run(restore=...)`` over the file spool on held-out prompts,
    every emitted token teacher-forced on the restored weights (the dense
    model), with the teacher's top-2 margin at each position."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.serving import Spool
    from pytorch_operator_tpu_torch.workloads import generate, serve

    rng = np.random.default_rng(8)
    shapes = [(int(rng.integers(96, 769)), int(rng.integers(64, 193))) for _ in range(12)]
    prompts = [held_out[1 + i, :p].tolist() for i, (p, _) in enumerate(shapes)]
    got, errors = {}, []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_journey_serve_") as spool_dir:
        spool = Spool(spool_dir)

        def client():
            try:
                ids = [spool.submit(prompt=pr, max_new_tokens=n) for pr, (_, n) in zip(prompts, shapes)]
                for i, rid in enumerate(ids):
                    got[i] = spool.wait_response(rid, timeout=900)
            except Exception as e:  # reported below: the phase fails on it
                errors.append(repr(e))

        thread = threading.Thread(target=client, daemon=True)
        thread.start()
        fa.reset_launch_count()
        stats = serve.run(config="0.3b", n_layers=JOURNEY_TRAIN["n_layers"], spool_dir=spool_dir,
                          restore=ck, **SERVE_KNOBS,
                          max_requests=len(shapes), idle_timeout=300, device="cuda", log=_log)
        launches = fa.launch_counts()
        thread.join(timeout=120)
    _record_launches(kernels, "journey_serve", launches)
    if errors or thread.is_alive() or len(got) != len(shapes):
        _fail(f"journey serve client failed: {errors or 'still waiting'}")
    if stats.get("restored_step") != JOURNEY_SAVED[1] or stats["served"] != len(shapes) or stats["rejected"]:
        _fail(f"journey serve: {stats}")
    for i, (p, n) in enumerate(shapes):
        if len(got[i].get("tokens") or []) != n:
            _fail(f"journey serve request {i}: {got[i]}")
    _log(f"journey serve --restore (restored_step {stats['restored_step']}, {len(shapes)} held-out "
         f"prompts {min(p for p, _ in shapes)}-{max(p for p, _ in shapes)}, "
         f"{sum(n for _, n in shapes)} new tokens): decode {stats['decode_tokens_per_sec']} tok/s, "
         f"TTFT p50 {stats['ttft_ms_p50']} ms, TPOT p50 {stats['tpot_ms_p50']} ms; launches {launches}")
    cfg = llama_lib.llama_0_3b(decode=True, max_decode_len=SERVE_KNOBS["max_decode_len"],
                               n_layers=JOURNEY_TRAIN["n_layers"])
    model, _, _ = generate.load_params(cfg, config="0.3b", device="cuda", restore=ck, log=_log, tag="serve")
    margins = []
    gaps = _teacher_gaps(model, margins)
    held = {f"held_out{i}": gaps(np.asarray(prompts[i], np.int32), got[i]["tokens"]) for i in got}
    margins = torch.cat(margins)
    _log(f"journey teacher's top-2 margin over the served positions (trained weights): min "
         f"{float(margins.min()):.4f}, 1st percentile {float(margins.quantile(0.01)):.4f}, median "
         f"{float(margins.median()):.4f}")
    _log(f"journey served continuation of held-out prompt 0: {_bytes_text(got[0]['tokens'])!r}")
    _hold_gaps("journey serve --restore (trained weights)", held)
    del model
    torch.cuda.empty_cache()


def _profile_journey_step(B: int = 16, S: int = JOURNEY_S):
    """Where one remat ``dots`` training step's time goes at the journey's
    shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.workloads import llama_train, trainer

    cfg = llama_lib.llama_0_3b(remat=True, remat_policy="dots", n_layers=JOURNEY_TRAIN["n_layers"])
    model = _train_model(cfg, seed=4)
    step = trainer.make_lm_train_step(model, trainer.make_optimizer(model.parameters(), 3e-4))
    toks = torch.from_numpy(llama_train.synthetic_bigram_batch(B, S, 256, 0)).to("cuda", torch.long)
    float(step(toks))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(toks))
        wall = time.perf_counter() - t0
    _report_profile(prof, wall, f"one remat dots training step ({cfg.n_layers} layers, B{B} x S{S})",
                    top=15)
    del model, step
    torch.cuda.empty_cache()


# Phase 9, the rest of the training path: adafactor, the device feed, async
# checkpoints and profiling, at llama_0_3b full width and depth.
REST_SHAPE = dict(config="0.3b", batch_size=4, seq_len=4096, warmup=1, steps=3)
# Adafactor's natural step is larger than AdamW's (optax's note on
# adafactor's learning rate): an update is about lr times the leaf's RMS.
ADAFACTOR_LR = 1e-2
# The journey's shape (B16 x S1024) without remat, on phase 8's corpus.
FEED_RUN = dict(config="0.3b", batch_size=16, seq_len=JOURNEY_S, warmup=2, steps=20)
# Phase 9(c) at a quarter of the depth (4 of 0.3b's 16 layers):
# 0.95 GB a step in place of 3.8 GB, the same blocking, async and enospc
# checks (the script's time budget, PERF.md §7).
CKPT_LAYERS = 4
CKPT_RUN = dict(config="0.3b", batch_size=16, seq_len=JOURNEY_S, warmup=1, steps=9,
                checkpoint_every=5, n_layers=CKPT_LAYERS)
# One adafactor update on the card against the same update on the CPU, from
# the same parameters, statistics and gradients, in f32: each tensor's
# update within this share of its largest element (means over up to 32,000
# elements summed in other orders, and pow, differ by ulps).
ADAFACTOR_CARD_CPU_RTOL = 1e-4
# The profiled run's device busy time a step against phase 5's profile of
# one step of the same shape.
PROFILE_BUSY_RTOL = 0.05


def _counted_run(kernels, path: str, total_steps: int, layers: int, **kw):
    """llama_train.run on the card with the launch counts set to 0 just
    before and read just after; each kernel once a layer a step (``layers``
    of them), over ``total_steps`` (warmup included)."""
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import llama_train

    fa.reset_launch_count()
    r = llama_train.run(device="cuda", log=_log, **kw)
    launches = fa.launch_counts()
    _record_launches(kernels, path, launches)
    want = _per_step(layers, remat=False)
    if launches != {k: v * total_steps for k, v in want.items()}:
        _fail(f"{path} launched {launches}, expected {want} a step over {total_steps} steps")
    if not all(math.isfinite(x) for x in r["losses"]):
        _fail(f"{path} losses not finite: {r['losses']}")
    return r


def phase_rest(kernels):
    """Phase 9: (a) adafactor beside AdamW; (b) the device feed; (c)
    asynchronous checkpoints ((d), preemption in subprocesses, is given up
    for the time limit). Returns (e), the profiled run, to run with the other profiles."""
    import shutil
    import tempfile

    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib

    n_layers = llama_lib.llama_0_3b().n_layers
    t0 = time.perf_counter()
    _rest_adafactor(kernels, n_layers)
    torch.cuda.empty_cache()
    _log(f"rest (a): {time.perf_counter() - t0:.1f} s")
    td = tempfile.mkdtemp(prefix="chip_smoke_rest_")
    try:
        train_f, _, _ = _journey_corpus(td)
        for part, run in (
            ("(b)", lambda: _rest_feed(kernels, n_layers, train_f)),
            ("(c)", lambda: _rest_async_checkpoint(kernels, train_f, td)),
        ):
            t0 = time.perf_counter()
            run()
            torch.cuda.empty_cache()
            _log(f"rest {part}: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(td, ignore_errors=True)

    def profile_rest():
        _profile_rest(kernels, n_layers)

    return profile_rest


def _rest_adafactor(kernels, n_layers):
    """(a) adafactor and AdamW runs of the same length at phase 5's shape:
    tokens/s, peak memory, optimizer state bytes; one update on the card
    against the CPU; each optimizer step's device time."""
    steps = REST_SHAPE["warmup"] + REST_SHAPE["steps"]
    runs = {}
    for opt, lr in (("adafactor", ADAFACTOR_LR), ("adamw", 3e-4)):
        r = _counted_run(kernels, f"rest_{opt}", steps, n_layers, optimizer=opt, lr=lr, **REST_SHAPE)
        runs[opt] = r
        _log(
            f"rest (a) {opt} 0.3b (B4 x S4096, lr {lr}): {r['value']} tokens/s, step "
            f"{r['step_s']:.4f} s, peak memory {r['peak_mem_bytes'] / 2**30:.2f} GiB, optimizer "
            f"state {r['optimizer_state_bytes']:,} bytes, losses {[round(x, 4) for x in r['losses']]}"
        )
    losses = runs["adafactor"]["losses"]
    if not losses[-1] < losses[0]:
        _fail(f"adafactor training loss did not fall: {losses}")
    from pytorch_operator_tpu_torch.models import llama as llama_lib

    a, w = runs["adafactor"]["optimizer_state_bytes"], runs["adamw"]["optimizer_state_bytes"]
    n = sum(p.numel() for p in llama_lib.Llama(llama_lib.llama_0_3b(), device="meta").parameters())
    _log(f"rest (a) optimizer state: adafactor {a:,} bytes, AdamW {w:,} bytes "
         f"(2N f32 = {8 * n:,}); ratio {a / w:.5f}")
    if not a < w:
        _fail("adafactor's state is not smaller than AdamW's")
    _adafactor_card_vs_cpu()


def _adafactor_card_vs_cpu(reps: int = 5):
    """One adafactor update on the card against the same update on the CPU
    (f32 parameters, statistics after one step, new gradients), and the
    device time of each optimizer's step on the 0.3b parameters (CUDA events
    around ``step()``; the gradients are set before each)."""
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.workloads import trainer

    cfg = llama_lib.llama_0_3b()
    model = _train_model(cfg, seed=5)
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    gen = torch.Generator(dev).manual_seed(6)
    grads = [{n: 1e-3 * torch.randn(p.shape, generator=gen, device=dev) for n, p in params.items()}
             for _ in range(2)]
    opt = trainer.make_optimizer(model, ADAFACTOR_LR, optimizer="adafactor")

    def set_grads(named, g):
        for n, p in named.items():
            p.grad = g[n].to(p.device)

    set_grads(params, grads[0])
    opt.step()
    cpu_model = llama_lib.Llama(cfg, device="meta")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, assign=True)
    cpu_opt = trainer.make_optimizer(cpu_model, ADAFACTOR_LR, optimizer="adafactor")
    state = opt.state_dict()
    cpu_opt.load_state_dict({"count": state["count"], "adafactor": {
        path: {k: t.cpu() for k, t in st.items()} for path, st in state["adafactor"].items()}})
    before = {k: v.detach().clone() for k, v in cpu_model.state_dict().items()}
    cpu_params = dict(cpu_model.named_parameters())
    set_grads(params, grads[1])
    set_grads(cpu_params, grads[1])
    opt.step()
    cpu_opt.step()
    worst, where = 0.0, None
    for name, p in params.items():
        d_card = p.detach().cpu() - before[name]
        d_cpu = cpu_params[name].detach() - before[name]
        err = (d_card - d_cpu).abs().max().item() / max(d_cpu.abs().max().item(), 1e-30)
        if err > worst:
            worst, where = err, name
    _log(f"rest (a) one adafactor update, card vs CPU (f32, 0.3b): worst tensor {where} "
         f"max |diff| / max |update| {worst:.3e} (tol {ADAFACTOR_CARD_CPU_RTOL:.0e})")
    if not worst <= ADAFACTOR_CARD_CPU_RTOL:
        _fail("adafactor's update on the card disagrees with the CPU's")
    del cpu_model, cpu_opt, cpu_params, before
    times = {}
    for name, o in (("adafactor", opt), ("adamw", trainer.make_optimizer(model, 3e-4))):
        set_grads(params, grads[0])
        o.step()  # AdamW makes its state at its first step
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        total = 0.0
        for _ in range(reps):
            set_grads(params, grads[1])
            start.record()
            o.step()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        times[name] = total / reps
    _log(f"rest (a) optimizer step on the card, 0.3b (CUDA events, mean of {reps}): adafactor "
         f"{times['adafactor']:.3f} ms, AdamW {times['adamw']:.3f} ms")
    del model, opt, grads
    torch.cuda.empty_cache()


def _rest_feed(kernels, n_layers, train_f):
    """(b) inline, prefetch=2, and prefetch=2 with autotune (depth_max 8, 2
    workers) on phase 8's corpus: the same losses step for step."""
    steps = FEED_RUN["warmup"] + FEED_RUN["steps"]
    runs = {}
    for name, kw in (
        ("inline", {}),
        ("prefetch", dict(prefetch=2)),
        ("prefetch_autotune", dict(prefetch=2, feed_autotune=True, prefetch_depth_max=8,
                                   prefetch_workers=2)),
    ):
        r = _counted_run(kernels, f"rest_{name}", steps, n_layers, data_file=train_f, **FEED_RUN, **kw)
        runs[name] = r
        feed = r.get("feed")
        _log(
            f"rest (b) {name} (B16 x S1024): {r['value']} tokens/s, step {r['step_s']:.4f} s"
            + (f", feed stall avg {feed['feed_stall_ms_avg']:.4f} ms recent "
               f"{feed['feed_stall_ms_recent']:.4f} ms, final depth {feed['depth']}, "
               f"workers {feed['workers']}" if feed else "")
        )
    for name in ("prefetch", "prefetch_autotune"):
        if runs[name]["losses"] != runs["inline"]["losses"]:
            diff = [i for i, (a, b) in enumerate(zip(runs[name]["losses"], runs["inline"]["losses"])) if a != b]
            _fail(f"{name} losses differ from the inline run's at steps {diff}")
    _log(f"rest (b) losses equal step for step over {steps} steps: last {runs['inline']['losses'][-1]}")


def _rest_async_checkpoint(kernels, train_f, td):
    """(c) blocking and async checkpoints every 5 steps into
    TPUJOB_CHECKPOINT_DIR with TPUJOB_STATUS_DIR set: every step committed
    with its sidecar and verified, one checkpoint_committed record an async
    save, each save's return time, the async step 10 restored equal to the
    blocking run's bit for bit; then a lost save under an
    enospc_checkpoint_write plan."""
    import json as _json
    import os
    import shutil
    from pathlib import Path

    import torch

    from pytorch_operator_tpu_torch import faults
    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager, integrity

    steps = CKPT_RUN["warmup"] + CKPT_RUN["steps"]
    committed_by_mode = {}
    runs = {}
    status = Path(td) / "status"
    status.mkdir()

    def records():
        path = status / "master-0.jsonl"
        return [_json.loads(x) for x in path.read_text().splitlines()] if path.exists() else []

    saved = {k: os.environ.get(k) for k in ("TPUJOB_CHECKPOINT_DIR", "TPUJOB_STATUS_DIR",
                                            "TPUJOB_FAULT_PLAN")}
    try:
        os.environ["TPUJOB_STATUS_DIR"] = str(status)
        for mode, kw in (("blocking", {}), ("async", dict(async_checkpoint=True)),
                         ("enospc", dict(async_checkpoint=True))):
            ck = Path(td) / f"ck_{mode}"
            os.environ["TPUJOB_CHECKPOINT_DIR"] = str(ck)
            if mode == "enospc":
                os.environ["TPUJOB_FAULT_PLAN"] = _json.dumps(
                    {"faults": [{"kind": "enospc_checkpoint_write", "nth": 2}]})
            faults.reset()
            n_before = len(records())
            r = _counted_run(kernels, f"rest_ckpt_{mode}", steps, CKPT_LAYERS, data_file=train_f,
                             **CKPT_RUN, **kw)
            recs = records()[n_before:]
            runs[mode] = (r, ck, recs)
            committed = [x for x in recs if x["event"] == "checkpoint_committed"]
            _log(f"rest (c) {mode}: {r['value']} tokens/s, save() returned in "
                 f"{[round(s, 4) for s in r['save_s']]} s, steps {integrity.list_steps(ck)}, "
                 f"checkpoint_committed {[(x['step'], x['commit_ms']) for x in committed]}")
            committed_by_mode[mode] = committed
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reset()
    for mode in ("blocking", "async"):
        r, ck, recs = runs[mode]
        if integrity.list_steps(ck) != [5, 10] or not all(
            integrity.verify_step(ck, s) is True for s in (5, 10)
        ):
            _fail(f"{mode} run's steps {integrity.list_steps(ck)} not [5, 10] all verified")
    committed = committed_by_mode["async"]
    if [x["step"] for x in committed] != [5, 10] or not all(x["commit_ms"] > 0 for x in committed):
        _fail(f"async run's checkpoint_committed records {committed}, expected one for 5 and 10")
    if runs["async"][0]["losses"] != runs["blocking"][0]["losses"]:
        _fail("async and blocking runs trained differently")
    like = {"params": {}, "opt_state": {}}
    a = CheckpointManager(runs["async"][1], create=False).restore(like, 10)
    b = CheckpointManager(runs["blocking"][1], create=False).restore(like, 10)
    differ = [n for n, t in b["params"].items() if not torch.equal(a["params"][n], t)]
    for i, st in b["opt_state"]["adamw"]["state"].items():
        differ += [f"{i}.{k}" for k, t in st.items()
                   if not torch.equal(a["opt_state"]["adamw"]["state"][i][k], t)]
    _log(f"rest (c) async step 10 restored against the blocking run's (the live state at 10): "
         f"{len(differ)} of {len(b['params'])} params + AdamW tensors differ")
    if differ or a["opt_state"]["count"] != b["opt_state"]["count"] != 10:
        _fail(f"async step 10 differs from the live state: {differ[:5]}")
    del a, b
    r, ck, recs = runs["enospc"]
    failed = [x for x in recs if x["event"] == "checkpoint_save_failed"]
    if [x["step"] for x in failed] != [10] or integrity.inflight_path(ck, 10).exists():
        _fail(f"enospc run: checkpoint_save_failed records {failed}, expected one for step 10")
    # The lost save at 10 was re-saved by the run's final blocking save.
    # Without that save (a life ended right after the loss) the restore
    # falls back past the lost step to the previous verified one.
    mgr = CheckpointManager(ck, create=False)
    ends_at = integrity.list_steps(ck)
    shutil.rmtree(ck / "10")
    integrity.sidecar_path(ck, 10).unlink()
    fallback = mgr.latest_verified_step()
    _log(f"rest (c) enospc: the run finished at {r['end_step']} with steps {ends_at}, "
         f"checkpoint_save_failed {[(x['step'], x['error'][:40]) for x in failed]}; without the "
         f"final save the restore falls back to step {fallback}")
    if ends_at != [5, 10] or fallback != 5:
        _fail("enospc run did not fall back to the previous verified step")


def _profile_rest(kernels, n_layers):
    """(e) llama_train.run with profile_dir at phase 5's shape, then
    profiling.device_report on the trace: the three kernels among its ops,
    its busy time a step within PROFILE_BUSY_RTOL of phase 5's profile."""
    import os
    import shutil
    import tempfile

    from pytorch_operator_tpu_torch import profiling

    d = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        kw = dict(REST_SHAPE, steps=2)
        _counted_run(kernels, "rest_profile", kw["warmup"] + kw["steps"], n_layers,
                     profile_dir=d, **kw)
        trace = profiling.find_trace(d)
        report = profiling.device_report(d, "cuda")
        if report is None:
            _fail("the profile holds no cuda plane")
        _log(f"rest (e) profile {trace.name} ({os.path.getsize(trace) / 2**20:.1f} MiB):\n"
             + profiling.format_report(report, top=12))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    ops = " ".join(r["op"] for r in report.get("top_ops", []))
    missing = [k for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if k not in ops]
    busy = report["busy_s"] / report["steps"]
    ref = PROFILE_READINGS.get("train_busy_s")
    _log(f"rest (e) device busy {1e3 * busy:.2f} ms a step over {report['steps']} steps, phase 5's "
         f"profile {1e3 * ref:.2f} ms (tol {PROFILE_BUSY_RTOL:.0%}); kernels missing: {missing}")
    if missing or report["steps"] != 2 or abs(busy - ref) > PROFILE_BUSY_RTOL * ref:
        _fail("the port profile report disagrees with phase 5's profile")


# Phase 10, the mixture-of-experts Llama: bench.py:438-467's ``moe`` block
# (0.3b width at 8 layers, 8 experts, top 2, capacity 1.25, aux 1e-2, bf16
# parameters, adafactor, remat ``dots``, B8 x 2048, 3 warmup + 12 steps),
# unchanged (sparse dispatch), and its dense twin.
MOE_RUN = dict(config="0.3b", batch_size=8, seq_len=2048, steps=12, warmup=3, n_layers=8,
               param_dtype="bfloat16", optimizer="adafactor", n_experts=8, moe_top_k=2,
               moe_dispatch="sparse", moe_aux_weight=1e-2, remat=True, remat_policy="dots")
# The JAX run's own counts of that block (BASELINE.md:250-253), which the
# shapes give too: 8 x (3.15M attention + 2 x 33.55M expert banks + 8,192
# router + 2,048 norm) + 2 x 32.77M embedding and head + 1,024 = 627.7M; the
# banks at top_k/E = 2/8 leave 225.0M active.
MOE_PARAMS_M, MOE_ACTIVE_M = 627.7, 225.0
# The layer at that width: 4,096 tokens of bf16 x, the weights at the
# model's init scale.
MOE_LAYER = dict(n_tokens=4096, d_model=1024, d_ff=4096, n_experts=8, top_k=2)
# The card's bf16 layer against the CPU's f32 run of the same inputs, by
# relative L2 (output, and the gradients of x, gate, w_in and w_out; output
# and x's gradient over the tokens routed alike on both). bf16 rounding of
# the same computation reads 3.8e-3 to 4.5e-3, both dispatches; the planted
# faults (top-k weights from the full softmax; the second choice dropped)
# read 0.44 and 0.51 (NVIDIA H100 80GB HBM3 at 700 W). Routing itself (f32
# logits, TF32 off) is held by the share of tokens with equal top-k indices
# (read: all of them).
MOE_REL_TOL = 2e-2
MOE_INDEX_AGREE_MIN = 0.999
# First-step losses of the sparse run and its dense twin (same seed, same
# weights, same batch): only the tokens that sparse dispatch drops differ.
MOE_FIRST_LOSS_TOL = 0.02


def _moe_layer_inputs(gen, device):
    """bf16 x [N, D], the upstream gradient, and the layer's parameters
    (bf16, lecun-scaled as the model's init)."""
    import torch

    L = MOE_LAYER
    N, D, Fd, E = L["n_tokens"], L["d_model"], L["d_ff"], L["n_experts"]

    def draw(shape, fan_in=1):
        return (torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)).bfloat16()

    params = {"gate": draw((D, E), D), "w_in": draw((E, D, Fd), E * D), "w_out": draw((E, Fd, D), E * Fd)}
    return params, draw((N, D)), draw((N, D))


def _moe_layer(params, x, dout, fn):
    """``fn``'s output and the gradients of x, gate, w_in and w_out under
    ``dout``."""
    import torch

    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    xin = x.detach().requires_grad_()
    out = fn(leaves, xin)
    grads = torch.autograd.grad(out, [xin, leaves["gate"], leaves["w_in"], leaves["w_out"]],
                                dout.to(out.dtype))
    return out.detach(), dict(zip(("x", "gate", "w_in", "w_out"), grads))


def _rel_l2(a, b) -> float:
    import torch

    a, b = a.float().cpu(), b.float().cpu()
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


def _moe_fns(cf: float = 1.25):
    from pytorch_operator_tpu_torch.parallel import moe

    k = MOE_LAYER["top_k"]
    return {
        "dense": lambda p, x: moe.moe_mlp_reference(p, x, top_k=k),
        "sparse": lambda p, x: moe.moe_mlp_sparse(p, x, top_k=k, capacity_factor=cf),
    }


def _moe_routes(params, x, dispatch: str):
    """Per token, what routing decided: the top-k indices (dense), or the
    experts that kept the token (sparse at capacity 1.25)."""
    from pytorch_operator_tpu_torch.parallel import moe

    k = MOE_LAYER["top_k"]
    _, idx, _ = moe._router_topk(params, x, k)
    if dispatch == "dense":
        return idx.cpu()
    N, E = x.shape[0], MOE_LAYER["n_experts"]
    g = min(1024, N)
    d, _ = moe._dispatch_tensors(params, x.reshape(N // g, g, -1), k, math.ceil(g * 1.25 * k / E))
    return d.sum(-1).reshape(N, E).cpu()


def phase_moe(kernels):
    """Phase 10: (a) the layer on the card against the CPU, with planted
    faults; (b) sparse against dense on the card; (c) bench.py's moe block
    and its dense twin through llama_train.run. Returns (d), the profiled
    sparse step, to run with the other profiles."""
    import torch

    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        _fail("TF32 is on: the router's f32 product would not be f32")
    t0 = time.perf_counter()
    _moe_layer_vs_cpu()
    torch.cuda.empty_cache()
    _log(f"moe (a), (b): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _moe_runs(kernels)
    torch.cuda.empty_cache()
    _log(f"moe (c): {time.perf_counter() - t0:.1f} s")
    return _profile_moe_step


def _moe_layer_vs_cpu():
    """(a) one forward and backward of each dispatch on the card against the
    plain f32 run on the CPU (the same bf16 values), planted faults read
    against the same reference; (b) sparse at capacity E/top_k against
    dense on the card, and the drop share at 1.25."""
    import torch

    from pytorch_operator_tpu_torch.parallel import moe

    L = MOE_LAYER
    params, x, dout = _moe_layer_inputs(torch.Generator(device="cuda").manual_seed(10), "cuda")
    cpu = ({k: v.cpu().float() for k, v in params.items()}, x.cpu().float(), dout.cpu().float())
    shape = f"N{L['n_tokens']} D{L['d_model']} F{L['d_ff']} E{L['n_experts']} top{L['top_k']}"
    refs = {}
    for dispatch, fn in _moe_fns().items():
        routes = _moe_routes(params, x, dispatch)
        ref_routes = _moe_routes(cpu[0], cpu[1], dispatch)
        alike = (routes == ref_routes).all(-1)
        _, idx, _ = moe._router_topk(params, x, L["top_k"])
        _, ref_idx, _ = moe._router_topk(cpu[0], cpu[1], L["top_k"])
        agree = (idx.cpu() == ref_idx).all(-1).float().mean().item()
        out, grads = _moe_layer(params, x, dout, fn)
        ref_out, ref_grads = _moe_layer(*cpu, fn)
        refs[dispatch] = (ref_out, ref_grads, alike)
        if not (torch.isfinite(out.float()).all() and out.shape == x.shape):
            _fail(f"moe {dispatch}: non-finite output or shape {tuple(out.shape)}")
        errs = {"out": _rel_l2(out.cpu()[alike], ref_out[alike]),
                "x": _rel_l2(grads["x"].cpu()[alike], ref_grads["x"][alike])}
        errs.update({k: _rel_l2(grads[k], ref_grads[k]) for k in ("gate", "w_in", "w_out")})
        worst = max(errs, key=errs.get)
        _log(f"moe (a) {dispatch} {shape} bf16 card vs f32 CPU: top-k indices equal for "
             f"{agree:.5f} of tokens (min {MOE_INDEX_AGREE_MIN}), routed alike {alike.float().mean():.5f}; "
             "rel L2 " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
             + f" (tol {MOE_REL_TOL:.0e})")
        if agree < MOE_INDEX_AGREE_MIN or errs[worst] > MOE_REL_TOL:
            _fail(f"the moe layer ({dispatch}) on the card disagrees with the CPU")
        del out, grads
    # Planted faults, forward only, against the sound CPU outputs: each must
    # read above the tolerance.
    route = moe._router_topk

    def full_softmax(p, xx, k):
        logits, idx, _ = route(p, xx, k)
        return logits, idx, torch.softmax(logits, -1).gather(-1, idx)

    def first_only(p, xx, k):
        logits, idx, probs = route(p, xx, k)
        keep = torch.zeros(k, device=probs.device)
        keep[0] = 1.0
        return logits, idx, probs * keep

    for fault, fake in (("top-k weights from the full softmax", full_softmax),
                        ("second choice dropped", first_only)):
        moe._router_topk = fake
        try:
            with torch.no_grad():
                reads = {d: _rel_l2(fn(params, x), refs[d][0]) for d, fn in _moe_fns().items()}
        finally:
            moe._router_topk = route
        _log(f"moe (a) planted fault, {fault}: output rel L2 "
             + ", ".join(f"{d} {v:.3e}" for d, v in reads.items()) + f" (must exceed {MOE_REL_TOL:.0e})")
        if min(reads.values()) <= MOE_REL_TOL:
            _fail(f"the tolerance does not catch the planted fault: {fault}")
    # (b) No token can drop at capacity factor E / top_k.
    ample = MOE_LAYER["n_experts"] / MOE_LAYER["top_k"]
    d_out, d_grads = _moe_layer(params, x, dout, _moe_fns()["dense"])
    s_out, s_grads = _moe_layer(params, x, dout, _moe_fns(ample)["sparse"])
    errs = {"out": _rel_l2(s_out, d_out), **{k: _rel_l2(s_grads[k], d_grads[k]) for k in d_grads}}
    N, k, E = MOE_LAYER["n_tokens"], MOE_LAYER["top_k"], MOE_LAYER["n_experts"]
    kept = _moe_routes(params, x, "sparse").sum().item()
    _log(f"moe (b) sparse (capacity factor {ample:g}) vs dense on the card: rel L2 "
         + ", ".join(f"{n} {v:.3e}" for n, v in errs.items()) + f" (tol {MOE_REL_TOL:.0e}); at "
         f"capacity 1.25 (C {math.ceil(1024 * 1.25 * k / E)} a group of 1024) "
         f"{1 - kept / (N * k):.4%} of (token, choice) pairs dropped")
    if max(errs.values()) > MOE_REL_TOL:
        _fail("sparse dispatch at ample capacity disagrees with dense dispatch")


def _moe_runs(kernels):
    """(c) bench.py's moe block through llama_train.run, then its dense twin;
    each with the launch counts set to 0 just before and read just after."""
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import llama_train

    total = MOE_RUN["warmup"] + MOE_RUN["steps"]
    want = _per_step(MOE_RUN["n_layers"], remat=True)
    first = {}
    for dispatch in ("sparse", "dense"):
        fa.reset_launch_count()
        r = llama_train.run(device="cuda", log=_log, **dict(MOE_RUN, moe_dispatch=dispatch))
        launches = fa.launch_counts()
        _record_launches(kernels, f"moe_{dispatch}", launches)
        losses, aux = r["losses"], r["aux_losses"]
        active = MOE_ACTIVE_M if dispatch == "sparse" else MOE_PARAMS_M
        _log(
            f"moe (c) {dispatch} (bench.py:438-467{'' if dispatch == 'sparse' else ', dense twin'}; "
            f"B8 x S2048, 8 layers): {r['value']} tokens/s, step {r['step_s']:.4f} s, peak memory "
            f"{r['peak_mem_bytes'] / 2**30:.2f} GiB, params_m {r['params_m']}, active_params_m "
            f"{r['active_params_m']}, losses {losses[0]:.4f} -> {losses[-1]:.4f}, aux "
            f"{aux[0]:.4f} -> {aux[-1]:.4f}, launches a step {r['flash_launches_per_step']}"
        )
        if launches != {name: n * total for name, n in want.items()}:
            _fail(f"moe {dispatch} launched {launches}, expected {want} a step over {total} steps")
        if (r["params_m"], r["active_params_m"], r["n_experts"], r["moe_dispatch"]) != (
            MOE_PARAMS_M, active, 8, dispatch
        ):
            _fail(f"moe {dispatch}: parameter counts or keys differ from the JAX run's")
        if len(losses) != total or not all(math.isfinite(v) for v in losses + aux):
            _fail(f"moe {dispatch}: losses or aux values not finite: {losses}, {aux}")
        first[dispatch] = losses[0]
    gap = abs(first["sparse"] - first["dense"])
    _log(f"moe (c) first-step losses sparse {first['sparse']:.5f}, dense {first['dense']:.5f}: "
         f"{gap:.5f} apart (tol {MOE_FIRST_LOSS_TOL})")
    if gap > MOE_FIRST_LOSS_TOL:
        _fail("the first steps of sparse and dense dispatch disagree")


# Where the profiled step's kernels go: the MoE layer's record_function
# ranges (parallel/moe.py), the flash kernels by name, the rest "other".
MOE_PARTS = ("moe.router", "moe.slots", "moe.dispatch", "moe.experts", "flash", "other")


def _moe_split(events, weight) -> dict:
    """Charge each event's ``weight`` (its kernels' time on the card) to a
    part of :data:`MOE_PARTS`: the innermost ``moe.*`` range around it; for a
    backward op, the range of the forward op whose autograd node it runs
    (same thread and sequence number); a flash kernel to ``flash``."""
    def label(e):
        while e is not None:
            if e.name in MOE_PARTS:
                return e.name, None
            if e.name.startswith("autograd::engine::evaluate_function") and e.sequence_nr >= 0:
                return None, (e.fwd_thread, e.sequence_nr)
            e = e.cpu_parent
        return None, None

    forward = {}
    for e in events:
        name, _ = label(e)
        if name is not None and e.sequence_nr >= 0:
            forward.setdefault((e.thread, e.sequence_nr), name)
    split = dict.fromkeys(MOE_PARTS, 0.0)
    for e in events:
        w = weight(e)
        if not w:
            continue
        name, node = label(e)
        if name is None and node is not None:
            name = forward.get(node)
        split[name or "other"] += w
    return split


def _kernel_ms(e) -> tuple:
    """(flash ms, other ms) of the kernels an event launched itself. A
    ``record_function`` range's projection on the card is listed among its
    kernels: left out, its kernels count as themselves."""
    if getattr(e, "is_user_annotation", False) or e.name in MOE_PARTS:
        return 0.0, 0.0
    flash = sum(k.duration for k in e.kernels if "flash_" in k.name) / 1e3
    return flash, sum(k.duration for k in e.kernels) / 1e3 - flash


def _profile_moe_step():
    """(d) Where one step of bench.py's moe block goes, sparse and then its
    dense twin: the card's busy time, split by MOE_PARTS."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.workloads import llama_train, trainer

    r = MOE_RUN
    toks = torch.from_numpy(llama_train.synthetic_bigram_batch(r["batch_size"], r["seq_len"], 32000, 0))
    toks = toks.to("cuda", torch.long)
    for dispatch in ("sparse", "dense"):
        cfg = llama_lib.llama_0_3b(
            n_layers=r["n_layers"], param_dtype=torch.bfloat16, n_experts=r["n_experts"],
            moe_top_k=r["moe_top_k"], moe_dispatch=dispatch, moe_aux_weight=r["moe_aux_weight"],
            remat=True, remat_policy="dots",
        )
        model = _train_model(cfg, seed=0)
        step = trainer.make_lm_train_step(model, trainer.make_optimizer(model, 3e-4, optimizer="adafactor"))
        float(step(toks))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(step(toks))
            wall = time.perf_counter() - t0
        busy, _ = _report_profile(prof, wall, f"one {dispatch} moe step (B8 x S2048, 8 layers)", top=15)
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
        split = _moe_split(events, lambda e: _kernel_ms(e)[1])
        split["flash"] += sum(_kernel_ms(e)[0] for e in events)
        charged, busy_ms = sum(split.values()), 1e3 * busy
        moe_ms = sum(split[k] for k in MOE_PARTS if k.startswith("moe."))
        _log(f"moe (d) {dispatch}: the step's kernels by part (ms, share of busy {busy_ms:.2f} ms): "
             + ", ".join(f"{k} {v:.2f} ({100 * v / busy_ms:.1f}%)" for k, v in split.items())
             + f"; charged {charged:.2f} ms; the MoE layer {100 * moe_ms / busy_ms:.1f}% of the busy time")
        if not (moe_ms > 0 and split["flash"] > 0 and charged <= 1.02 * busy_ms):
            _fail(f"the {dispatch} moe step's split does not add up")
        del model, step, prof
        torch.cuda.empty_cache()


# Phase 11: worlds of two processes on the one card. NCCL refuses two ranks
# of one communicator on one GPU, so the ranks share cuda:0 over gloo
# (runtime/rendezvous.choose_backend): this proves the multi-process path
# with the real kernels in every rank, and measures no scaling.
# At 4 of 0.3b's 16 layers (the script's time budget; PERF.md §7).
# 2 layers, for the script's time limit.
DIST_RUN = dict(config="0.3b", batch_size=4, seq_len=4096, warmup=1, steps=5, grad_clip=1.0,
                n_layers=2)
# The fsdp=2 run saves asynchronously at step 4 and blocking at its end (6).
DIST_CKPT_EVERY = 4
# The two-rank runs' losses against the one-process run of the same global
# batch: the largest absolute difference over the 6 steps, in nats (the
# losses fall from 10.85 to 0.015, so a relative limit would be set by the
# last, smallest ones). Readings on the NVIDIA H100 80GB HBM3 at 700 W: fsdp=2 3.6e-04 (bf16
# GEMMs over half the rows, another reduction order, carried through steps
# of large updates); a planted fault, every rank training on rank 0's rows,
# 0.362 (6.2e-03 at the first step).
DIST_LOSS_ATOL = 5e-3
# fsdp=2: each rank's parameter and AdamW bytes within this share of half
# the one-process run's (FSDP2's dim-0 chunks are ceil-sized).
DIST_HALF_RTOL = 0.01
# Timeout of one world's ranks, in seconds.
DIST_WORLD_TIMEOUT = 420


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_world(argv, tag: str, n: int = 2, env=None) -> list:
    """Start ``n`` ranks of ``argv`` with the environment the supervisor
    injects (runtime/env.py of the JAX package: the TPUJOB_* world, the c10d
    MASTER_*/WORLD_SIZE/RANK) plus ``env``, wait for all, kill any left at
    the timeout; their (exit code, stdout, stderr). Fails unless every rank
    exits 0."""
    import os
    from pathlib import Path

    root = str(Path(__file__).resolve().parent)
    base = {k: v for k, v in os.environ.items() if not k.startswith("TPUJOB_")}
    base["PYTHONPATH"] = root + os.pathsep + base.get("PYTHONPATH", "")
    # A rank that crashes prints its Python stack (faulthandler).
    base["PYTHONFAULTHANDLER"] = "1"
    base.update(env or {})
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(n):
            env = dict(base, TPUJOB_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       TPUJOB_NUM_PROCESSES=str(n), TPUJOB_PROCESS_ID=str(rank),
                       TPUJOB_REPLICA_TYPE="Master" if rank == 0 else "Worker",
                       TPUJOB_REPLICA_INDEX=str(0 if rank == 0 else rank - 1),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(n),
                       RANK=str(rank))
            procs.append(subprocess.Popen(argv, cwd=root, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        outs = []
        for proc in procs:
            left = max(DIST_WORLD_TIMEOUT - (time.perf_counter() - t0), 1)
            try:
                out, err = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            outs.append((proc.returncode, out, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    _log(f"dist {tag}: {n} ranks, exit codes {[o[0] for o in outs]}, "
         f"{time.perf_counter() - t0:.1f} s")
    for rank, (code, out, err) in enumerate(outs):
        if code != 0:
            _fail(f"dist {tag}: rank {rank} exited {code}\n{out[-3000:]}\n{err[-4000:]}")
    return outs


def _rank_world(task: str, tag: str, env=None, n: int = 2, **kw) -> list:
    """A world of ``n`` ranks of this script (``--rank task``), each writing
    its output as JSON; the outputs in rank order."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory(prefix="chip_smoke_rank_") as td:
        argv = [sys.executable, __file__, "--rank", task, json.dumps(dict(kw, out=td))]
        _run_world(argv, tag, n=n, env=env)
        return [json.loads((Path(td) / f"r{r}.json").read_text()) for r in range(n)]


def _rank_main(task: str, kw: dict) -> int:
    """One rank of a phase-11, 12, 13, 14, 15 or 16 world: join from the env, run
    ``task``, write this rank's output, leave through
    ``rendezvous.finalize``. A run of ``"runs"`` may set environment
    variables first (its ``env``)."""
    import os
    from pathlib import Path

    import torch

    import gc

    from pytorch_operator_tpu_torch.runtime import rendezvous
    from pytorch_operator_tpu_torch.runtime.device import device_name

    world = rendezvous.initialize_from_env()
    dev = torch.device(world.device)
    out = {"rank": world.process_id, "backend": world.backend, "device": world.device,
           "device_name": device_name(dev)}
    if task == "runs":
        # Phases 11, 13, 14 and 15: several llama_train runs in one world,
        # each under its planted fault if it names one; phase 11's world
        # first probes the collectives.
        if kw.get("probe"):
            out.update(_rank_probe(world, dev))
        out["runs"] = []
        for run_kw in kw["runs"]:
            run_kw = dict(run_kw)
            os.environ.update(run_kw.pop("env", {}))
            t_run = time.perf_counter()
            with _planted(run_kw.pop("plant", None)):
                out["runs"].append(_rank_train(run_kw))
            out["runs"][-1]["wall_s"] = time.perf_counter() - t_run
            gc.collect()  # a run's FSDP2 modules hold reference cycles
            torch.cuda.empty_cache()
    elif task == "bert":
        # Phase 16(f): bert_fsdp runs in one world, each with its flash
        # launches and, with ``digest``, digests of its gathered parameters
        # (all, and those tp holds whole); then the tp module check of
        # ``module``'s config.
        from pytorch_operator_tpu_torch.ops import flash_attention as fa
        from pytorch_operator_tpu_torch.parallel.sharding import BERT_PARAM_AXES, axis_dim
        from pytorch_operator_tpu_torch.workloads import bert_fsdp

        out["runs"] = []
        for run_kw in kw["runs"]:
            run_kw = dict(run_kw)
            digest = run_kw.pop("digest", False)
            fa.reset_launch_count()
            t_run = time.perf_counter()
            r = bert_fsdp.run(log=_log, keep_params=digest, **run_kw)
            done = {"flash_launches": fa.launch_counts()}
            params = r.pop("params", None)
            if digest:
                done["digest"] = _params_digest(params.items())
                done["whole_digest"] = _params_digest(
                    (n, t) for n, t in params.items() if axis_dim(n, "tp", table=BERT_PARAM_AXES) is None)
            del params
            out["runs"].append(dict(done, result=r, wall_s=time.perf_counter() - t_run))
            gc.collect()  # a run's FSDP2 modules hold reference cycles
            torch.cuda.empty_cache()
        if kw.get("module"):
            t_run = time.perf_counter()
            out["module"] = _bert_tp_module(dev, kw["module"])
            out["module_s"] = time.perf_counter() - t_run
    elif task == "resnet":
        from pytorch_operator_tpu_torch.models import resnet
        from pytorch_operator_tpu_torch.workloads import resnet_bench

        args = {k: v for k, v in kw.items() if k != "out"}
        fault_too = args.pop("then_per_rank_bn", False)
        out["result"] = resnet_bench.run_benchmark(log=_log, **args)
        if fault_too:  # phase 12(d)'s planted fault: plain DDP's batch norm
            gc.collect()
            torch.cuda.empty_cache()
            init = resnet.BatchNorm.__init__
            resnet.BatchNorm.__init__ = lambda self, c, **k: init(self, c, **dict(k, sync_stats=False))
            try:
                out["fault"] = resnet_bench.run_benchmark(log=_log, **args)
            finally:
                resnet.BatchNorm.__init__ = init
    else:
        out.update(_rank_train(kw))
    (Path(kw["out"]) / f"r{world.process_id}.json").write_text(json.dumps(out))
    rendezvous.finalize(world, 0)
    return 0


def _rank_probe(world, dev) -> dict:
    """Each collective of parallel/collectives.py on CUDA tensors, over a
    dp mesh of the world, against its value computed here."""
    import torch

    from pytorch_operator_tpu_torch.parallel import collectives as c
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh

    n, r = world.num_processes, world.process_id
    mesh = make_mesh({"dp": n}, dev.type)
    xs = [torch.arange(8.0, device=dev).view(2, 4) + 100 * i for i in range(n)]
    total = sum(xs)
    want = {
        "psum": total, "pmean": total / n, "all_gather": torch.cat(xs),
        "all_gather_stacked": torch.stack(xs), "reduce_scatter": total.chunk(n)[r],
        "ring_shift": xs[(r - 1) % n],
    }
    got = {
        "psum": c.psum(xs[r], "dp", mesh), "pmean": c.pmean(xs[r], "dp", mesh),
        "all_gather": c.all_gather(xs[r], "dp", mesh),
        "all_gather_stacked": c.all_gather(xs[r], "dp", mesh, tiled=False),
        "reduce_scatter": c.reduce_scatter(xs[r], "dp", mesh),
        "ring_shift": c.ring_shift(xs[r], "dp", mesh),
    }
    return {"collectives": {
        k: bool(torch.equal(got[k], want[k]) and got[k].device == dev) for k in want
    }}


def _rank_train(kw: dict) -> dict:
    """``llama_train.run`` on the card (this rank's device); with
    ``digest`` a blake2b of the trained parameters gathered from the shards
    (``sharding.full_tensor``), in state-dict order; with ``save`` (a file
    name and tensor names) rank 0 writes those gathered tensors there."""
    from pytorch_operator_tpu_torch.workloads import llama_train

    kw = {k: v for k, v in kw.items() if k != "out"}
    want_digest = kw.pop("digest", False)
    save = kw.pop("save", None)
    r = llama_train.run(log=_log, keep_params=want_digest or save is not None, **kw)
    params = r.pop("params", None)
    out = {"result": r}
    if want_digest:
        out["params"] = _params_digest(params.items())
    if save is not None:
        import torch
        import torch.distributed as dist

        if dist.get_rank() == 0:
            torch.save({name: params[name] for name in save[1]}, save[0])
    return out


def _params_digest(named) -> str:
    """blake2b over (name, bytes) of each tensor, in the given order."""
    import hashlib

    import torch

    h = hashlib.blake2b(digest_size=16)
    for name, t in named:
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dist_launches(kernels, path: str, results, total_steps: int, n_layers: int) -> dict:
    """Sum the ranks' flash launches into the kernels line under ``path``;
    each rank must have launched each kernel once a layer a step."""
    want = _per_step(n_layers, remat=False)
    summed = {}
    for r in results:
        got = r["flash_launches"]
        if got != {k: v * total_steps for k, v in want.items()}:
            _fail(f"dist {path}: rank {r['rank']} launched {got}, expected {want} a step over "
                  f"{total_steps} steps")
        for k, v in got.items():
            summed[k] = summed.get(k, 0) + v
    _record_launches(kernels, path, summed)
    return summed


def phase_dist(kernels):
    """Phase 11: (a) two ranks on the card, each collective on CUDA tensors;
    (b) smoke_dist; (c) llama_train at 0.3b, one process and two ranks
    (fsdp=2, dp=2), losses held against the one process's; (d) the fsdp=2
    run's checkpoints restored by one process and resumed by two ranks. The
    kernels at the per-rank shape (B2 S4096) are timed in phases 2-3."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager, integrity
    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import llama_train

    torch.cuda.empty_cache()
    n_layers = DIST_RUN.get("n_layers", llama_lib.llama_0_3b().n_layers)
    total = DIST_RUN["warmup"] + DIST_RUN["steps"]
    t0 = time.perf_counter()
    outs = _run_world([sys.executable, "-m", "pytorch_operator_tpu_torch.workloads.smoke_dist"],
                      "(b) smoke_dist")
    for rank, (_, out, _) in enumerate(outs):
        if f"rank {rank}: OK" not in out or "backend gloo" not in out:
            _fail(f"dist (b): smoke_dist rank {rank} did not pass:\n{out[-2000:]}")
    _log(f"dist (b): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    fa.reset_launch_count()
    one = llama_train.run(device="cuda", log=_log, **DIST_RUN)
    _record_launches(kernels, "dist_one_process", fa.launch_counts())
    torch.cuda.empty_cache()
    td = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        ck = Path(td) / "ck"
        # One world of two ranks probes the collectives (a) and runs both
        # meshes (a world's start-up is ~10 s); only the fsdp=2 run
        # checkpoints.
        outs = _rank_world("runs", "(a) collectives, (c) fsdp=2 and dp=2", probe=True,
                           env={"TPUJOB_CHECKPOINT_DIR": str(ck)}, runs=[
            dict(DIST_RUN, mesh_spec="fsdp=2", digest=True, checkpoint_every=DIST_CKPT_EVERY,
                 async_checkpoint=True),
            dict(DIST_RUN, mesh_spec="dp=2"),
        ])
        for out in outs:
            _log(f"dist (a) rank {out['rank']}: backend {out['backend']}, device {out['device']} "
                 f"({out['device_name']}), collectives on CUDA tensors {out['collectives']}")
            if out["backend"] != "gloo" or not all(out["collectives"].values()):
                _fail(f"dist (a): rank {out['rank']}: backend {out['backend']}, or a collective is wrong")
        fsdp, dp = ([o["runs"][i] for o in outs] for i in (0, 1))
        _log(f"dist (a), (c): {time.perf_counter() - t0:.1f} s")
        runs = {"fsdp=2": fsdp, "dp=2": dp}
        for mesh, outs in runs.items():
            r = outs[0]["result"]
            per = r["per_rank"]
            _dist_launches(kernels, f"dist_{mesh}", per, total, n_layers)
            gap = max(abs(a - b) for a, b in zip(r["losses"], one["losses"]))
            _log(
                f"dist (c) {mesh} (two ranks sharing one card): {r['value'] * 2:.1f} tokens/s, step "
                f"{r['step_s']:.4f} s, losses {[round(x, 5) for x in r['losses']]} against one "
                f"process's {[round(x, 5) for x in one['losses']]}: largest difference "
                f"{gap:.3e} (limit {DIST_LOSS_ATOL:.0e}); per rank: param bytes "
                f"{[q['param_bytes'] for q in per]}, AdamW bytes "
                f"{[q['optimizer_state_bytes'] for q in per]}, peak memory GiB "
                f"{[round((q['peak_mem_bytes'] or 0) / 2**30, 2) for q in per]}, launches a step "
                f"{r['flash_launches_per_step']}; backend {r['backend']}, mesh {r['mesh']}"
            )
            if (r["world"], r["backend"], len(r["losses"])) != (2, "gloo", total):
                _fail(f"dist (c) {mesh}: world, backend or step count wrong: {r['world']}, "
                      f"{r['backend']}, {len(r['losses'])}")
            if gap > DIST_LOSS_ATOL:
                _fail(f"dist (c) {mesh}: losses differ from the one-process run's by {gap:.3e}")
        _log(f"dist (c) one process (B4 x S4096): {one['value']} tokens/s, step {one['step_s']:.4f} s, "
             f"param bytes {one['param_bytes']}, AdamW bytes {one['optimizer_state_bytes']}, peak "
             f"memory {(one['peak_mem_bytes'] or 0) / 2**30:.2f} GiB")
        for q in fsdp[0]["result"]["per_rank"]:
            for key in ("param_bytes", "optimizer_state_bytes"):
                if abs(q[key] - one[key] / 2) > DIST_HALF_RTOL * one[key] / 2:
                    _fail(f"dist (c) fsdp=2: rank {q['rank']} holds {q[key]} {key}, not about half "
                          f"of {one[key]}")
        for q in dp[0]["result"]["per_rank"]:
            if (q["param_bytes"], q["optimizer_state_bytes"]) != (
                one["param_bytes"], one["optimizer_state_bytes"]
            ):
                _fail(f"dist (c) dp=2: rank {q['rank']} does not hold the whole state")

        # (d) the fsdp=2 run's steps: 4 (async) and 6 (blocking, the end)
        t0 = time.perf_counter()
        saved = fsdp[0]["result"]
        steps = integrity.list_steps(ck)
        verified = [integrity.verify_step(ck, x) for x in steps]
        files = sorted(p.name for p in (ck / "6").iterdir())
        _log(f"dist (d) fsdp=2 saves: steps {steps}, verified {verified}, save_s "
             f"{[round(x, 3) for x in saved.get('save_s', [])]}, step 6 files {files}")
        if steps != [4, 6] or verified != [True, True] or len(saved.get("save_s", [])) != 1:
            _fail("dist (d): the fsdp=2 run did not commit steps 4 (async) and 6 (blocking)")
        t1 = time.perf_counter()
        step, params = CheckpointManager(ck, create=False).restore_subtree("params")
        restored = _params_digest(params.items())
        del params
        ranks_digest = {out["params"] for out in fsdp}
        _log(f"dist (d) one-process restore of step {step}: {time.perf_counter() - t1:.1f} s, "
             f"digest {restored}; the two ranks' gathered parameters {sorted(ranks_digest)}")
        if step != 6 or ranks_digest != {restored}:
            _fail("dist (d): the one-process restore differs from the ranks' gathered parameters")
        shutil.rmtree(ck / "6")
        integrity.sidecar_path(ck, 6).unlink()
        resumed = _rank_world(
            "train", "(d) fsdp=2 resume", env={"TPUJOB_CHECKPOINT_DIR": str(ck)},
            mesh_spec="fsdp=2", max_steps=total, **DIST_RUN,
            checkpoint_every=DIST_CKPT_EVERY,
        )[0]["result"]
        _dist_launches(kernels, "dist_resume", resumed["per_rank"], total - 4, n_layers)
        want = saved["losses"][4:]
        _log(f"dist (d) two-rank resume at step 4: losses {resumed['losses']}, the uninterrupted "
             f"run's steps 5-6 {want}: {'bit-equal' if resumed['losses'] == want else 'DIFFER'}; "
             f"{time.perf_counter() - t0:.1f} s")
        if resumed["end_step"] != total or resumed["losses"] != want:
            _fail("dist (d): the two-rank resume's losses differ from the uninterrupted run's")
    finally:
        shutil.rmtree(td, ignore_errors=True)
    return None


# Phase 12: the image models. ResNet-50 as examples/resnet.yaml runs it
# (bench.py's headline), resnet_ab, a packed file, a two-rank world, ViT-B/16
# dense and flash, and the latency probe.
RESNET_RUN = dict(depth=50, batch_size=128, image_size=224, classes=1000, steps=30, warmup=5,
                  windows=3)
# bench.py:64's count of a ResNet-50 training step's operations an image (3x
# the forward's 4.1 GFLOP): an operation count, not a time.
RESNET50_TRAIN_FLOPS_PER_IMG = 3 * 4.1e9
AB_ARGS = dict(variant_names=["plain", "s2d"], rounds=2)
# The file run: the port's pack writes 1,024 images of 112 px (154 MB of f32)
# under TMPDIR; B128, one warm chunk of 4 steps and a window of 4.
FILE_PACK = ["--dataset", "synthetic", "--n", "1024", "--height", "112", "--width", "112",
             "--classes", "1000"]
FILE_RUN = dict(depth=50, batch_size=128, classes=1000, steps=4, warmup=1)
# Two ranks sharing cuda:0 over gloo, global B64: a warm chunk of 3 steps and
# a window of 3.
IMAGE_WORLD_RUN = dict(depth=50, batch_size=64, image_size=224, classes=1000, steps=3, warmup=1)
VIT_RUN = dict(variant="b16", batch_size=128, image_size=224, classes=1000, steps=10, warmup=1,
               windows=2)
VIT_LAYERS = 12
# (a) Card against CPU in f32, TF32 off (cuBLAS and cuDNN), on the same
# weights: the relative L2 error of the logits, the largest of any gradient
# (its norm floored at a tenth of the mean gradient norm) and of any
# batch-norm buffer. Readings (NVIDIA H100 80GB HBM3, 700 W): ResNet-50
# 6.4e-5, 1.6e-2, 6.4e-5; ViT-B/16 1.2e-6, 4.1e-6, none. ResNet-50's gradients
# at B2 x 64 px are ill-conditioned in f32 itself (the last stage's batch
# norms see 8 values a channel): a one-ulp change of the input moves them by
# 1.8e-2 on the CPU alone (tests/test_torch_resnet.py, the conditioning
# test), hence their wider limit. Each planted fault, on the card only, must read
# above at least one limit: symmetric SAME padding 0.56 / 1.8 / 0.89, the
# unbiased running variance 7.3e-2 on the buffers, the LayerNorm epsilon
# 5.1e-3 on the logits.
IMAGE_CARD_CPU_RTOL = {"logits": 1e-3, "grad": 5e-2, "buffers": 1e-3}
# (b) The batch norm's two paths on the headline's step (ResNet-50, B128 x
# 224 px): ``BatchNorm._fused`` (one ``F.batch_norm``; one process, f32
# statistics) and ``_summed`` (the statistics summed by the port; a world and
# bf16 statistics), switched on one model between windows of this many steps
# timed by CUDA events, interleaved fused, summed, summed, fused.
BN_AB_STEPS = 10
# Each limit below lies between the sound reading and a planted fault's, both
# read on the card (NVIDIA H100 80GB HBM3, 700 W).
# (c) s2d against the plain stem: the gap of resnet_ab's first-step losses,
# in nats. Readings: sound 6.2e-6; a wrong s2d regrouping (each 2x2 block of
# the input transposed) 5.1e-3.
S2D_FIRST_LOSS_ATOL = 2e-4
# (d) Two ranks with global batch norm against one process, global B64: the
# largest gap of the first chunk's WORLD_CHECK_STEPS losses, in nats (later
# steps drift apart: 2.7e-3 by step 5). Readings: sound 3.9e-4; per-rank
# batch norm (each rank's own statistics, as plain DDP) 6.4e-3.
WORLD_CHECK_STEPS = 3
WORLD_LOSS_ATOL = 1.5e-3
# (e) ViT-B/16 flash against dense, both bf16: the largest gap of steps
# 2..VIT_CHECK_STEPS (after the zero head has moved; step 1's logits are 0 on
# either path), in nats, beside dense bf16's own drift from dense f32 (TF32
# off) over the same steps. Readings: flash 2.7e-3, dense's drift 4.0e-3; the
# padded keys attended 7.3.
VIT_CHECK_STEPS = 10
VIT_LOSS_ATOL = 1e-2


def _image_batch(n: int, hw: int, seed: int = 0):
    import torch

    from pytorch_operator_tpu_torch.workloads.datasets import synthetic_images

    x, y = synthetic_images(n, hw, hw, 1000, seed=seed)
    return torch.from_numpy(x), torch.from_numpy(y).long()


def _grads_and_buffers(model, x, y):
    """One training forward and backward: (logits, loss, grads, buffers) on
    the CPU."""
    import torch.nn.functional as F

    logits = model(x)
    loss = F.cross_entropy(logits, y, label_smoothing=0.1)
    loss.backward()
    grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
    bufs = {n: b.detach().float().cpu() for n, b in model.named_buffers()}
    return logits.detach().float().cpu(), float(loss.detach()), grads, bufs


def _gap(card, cpu) -> dict:
    """The largest relative L2 errors of the logits, the gradients and the
    buffers of a card run against the CPU's."""
    import torch

    floor = 0.1 * sum(torch.linalg.vector_norm(g).item() for g in cpu[2].values()) / len(cpu[2])
    grad = max(torch.linalg.vector_norm(card[2][n] - g).item()
               / max(torch.linalg.vector_norm(g).item(), floor) for n, g in cpu[2].items())
    bufs = max((_rel_l2(card[3][n], b) for n, b in cpu[3].items()), default=0.0)
    return {"logits": _rel_l2(card[0], cpu[0]), "loss": abs(card[1] - cpu[1]), "grad": grad,
            "buffers": bufs}


def _resnet50_f32(seed: int = 0):
    """ResNet-50 in f32 from ``seed`` with every BN scale drawn around 1 (the
    zero scales of the blocks' last BN would leave their convs' gradients
    at zero), on the CPU."""
    import torch

    from pytorch_operator_tpu_torch.models import resnet

    model = resnet.ResNet50(dtype=torch.float32, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, resnet.BatchNorm):
                m.weight.normal_(1.0, 0.1, generator=gen)
    return model


def _vit64_f32(attn_impl: str):
    """ViT-B/16 built for 64 px (17 tokens) in f32, with a random head (the
    zero head reads nothing), on the CPU."""
    import torch

    from pytorch_operator_tpu_torch.models import vit

    model = vit.ViT(vit.vit_b16(image_size=64, dtype=torch.float32, attn_impl=attn_impl))
    with torch.no_grad():
        model.head.weight.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(1))
    return model


def _image_card_vs_cpu():
    """(a) ResNet-50 (B2 x 64 px) and ViT-B/16 (B2 x 64 px, dense and flash)
    in f32 on the card against the CPU on the same weights; each planted
    fault, on the card only, read against the same limit."""
    import torch

    from pytorch_operator_tpu_torch.models import resnet, vit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, y = _image_batch(2, 64)

    def card(build, patch=None):
        model = build().to("cuda")
        if isinstance(model, resnet.ResNet):
            model.to(memory_format=torch.channels_last)
        saved = []
        try:
            for obj, attr, value in patch or ():
                saved.append((obj, attr, getattr(obj, attr)))
                setattr(obj, attr, value)
            return _grads_and_buffers(model, x.cuda(), y.cuda())
        finally:
            for obj, attr, value in reversed(saved):
                setattr(obj, attr, value)

    def unbiased(self, xb):
        import torch.nn.functional as F

        return F.batch_norm(xb, self.running_mean, self.running_var, self.weight, self.bias,
                            True, 0.1, resnet.BN_EPS)

    models = {
        "resnet50": (_resnet50_f32, [
            ("symmetric SAME padding", [(resnet, "same_pads", lambda size, k, st: ((k - 1) // 2,) * 2)]),
            ("unbiased running variance", [(resnet.BatchNorm, "_fused", unbiased)]),
        ]),
        "vit_b16_dense": (lambda: _vit64_f32("dense"), [
            ("LayerNorm epsilon 1e-5", [(vit, "LN_EPS", 1e-5)]),
        ]),
        "vit_b16_flash": (lambda: _vit64_f32("flash"), []),
    }
    def above(read):
        return [k for k, lim in IMAGE_CARD_CPU_RTOL.items() if read[k] > lim]

    for name, (build, faults_) in models.items():
        ref = _grads_and_buffers(build(), x, y)
        sound = _gap(card(build), ref)
        _log(f"image (a) {name} f32, card vs CPU: " + ", ".join(f"{k} {v:.3e}" for k, v in sound.items())
             + f" (limits {IMAGE_CARD_CPU_RTOL})")
        if above(sound):
            _fail(f"image (a) {name}: the card disagrees with the CPU ({sound})")
        for fname, patch in faults_:
            read = _gap(card(build, patch), ref)
            _log(f"image (a) {name} planted fault ({fname}): " + ", ".join(f"{k} {v:.3e}" for k, v in read.items())
                 + f"; above the limit: {above(read)}")
            if not above(read):
                _fail(f"image (a) {name}: the planted fault {fname} reads within the limits")
        torch.cuda.empty_cache()


def _image_headline():
    """(b) resnet_bench as examples/resnet.yaml runs it, after the layout is
    confirmed: channels_last weights and conv outputs."""
    import torch

    from pytorch_operator_tpu_torch.models import resnet
    from pytorch_operator_tpu_torch.workloads import resnet_bench

    model = resnet_bench.build_model(50, classes=1000, device="cuda")
    formats = []
    hook = model.conv_init.register_forward_hook(
        lambda m, i, o: formats.append(o.is_contiguous(memory_format=torch.channels_last)))
    with torch.no_grad():
        model(_image_batch(2, 224)[0].cuda().to(torch.bfloat16))
    hook.remove()
    _log(f"image (b) layout: weights {resnet.memory_format(model)}, stem output channels_last {formats}")
    if resnet.memory_format(model) != torch.channels_last or formats != [True]:
        _fail("image (b): the ResNet is not channels_last on the card")
    del model
    torch.cuda.empty_cache()
    r = resnet_bench.run_benchmark(device="cuda", log=_log, **RESNET_RUN)
    share = r["value"] * RESNET50_TRAIN_FLOPS_PER_IMG / PEAK_OPS["bfloat16"]
    _log(f"image (b) ResNet-50 B{r['global_batch']} x 224 px: {r['value']} images/sec/chip "
         f"(min fenced window {r['min_window_images_per_sec_per_chip']}), step {r['step_time_ms']} ms, "
         f"peak memory {r['peak_mem_bytes'] / 2**30:.2f} GiB, losses {r['losses'][0]:.4f} -> "
         f"{r['final_loss']}, {len(r['losses'])} steps; {100 * share:.1f}% of the dense bf16 peak "
         f"by bench.py's 3 x 4.1 GFLOP an image; weights {r['memory_format']}")
    if r["memory_format"] != "channels_last" or not all(math.isfinite(v) for v in r["losses"]):
        _fail(f"image (b): layout {r['memory_format']} or non-finite losses")
    _bn_paths_ab()
    return r


def _bn_paths_ab():
    """(b) One ResNet-50 B128 x 224 px training step with each batch-norm
    path (``BN_AB_STEPS``), ms a step by CUDA events."""
    import torch

    from pytorch_operator_tpu_torch.models import resnet
    from pytorch_operator_tpu_torch.workloads import resnet_bench

    x, y = _image_batch(128, 224)
    x, y = x.cuda().to(torch.bfloat16), y.cuda()
    step, _ = resnet_bench.make_train_step(
        resnet_bench.build_model(50, classes=1000, device="cuda"), lr=0.1, momentum=0.9)
    fused = resnet.BatchNorm._fused
    ms = {"fused": [], "summed": []}
    try:
        for path in ("fused", "summed", "summed", "fused"):
            resnet.BatchNorm._fused = fused if path == "fused" else resnet.BatchNorm._summed
            for _ in range(2):
                float(step(x, y))
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(BN_AB_STEPS):
                loss = step(x, y)
            end.record()
            end.synchronize()
            if not math.isfinite(float(loss)):
                _fail(f"image (b) batch-norm A/B: the {path} path's loss is not finite")
            ms[path].append((start.elapsed_time(end) / BN_AB_STEPS, torch.cuda.max_memory_allocated()))
    finally:
        resnet.BatchNorm._fused = fused
    del step
    torch.cuda.empty_cache()
    _log("image (b) batch-norm paths, ResNet-50 B128 x 224 px step (ms, peak GiB) by window: " + "; ".join(
        f"{p} " + ", ".join(f"{t:.3f} ms {m / 2**30:.2f} GiB" for t, m in v) for p, v in ms.items())
        + f"; summed / fused {min(t for t, _ in ms['summed']) / min(t for t, _ in ms['fused']):.3f}x")


def _image_ab_and_file():
    """(c) resnet_ab plain against s2d (equal first-step losses); then a
    packed file, inline and prefetched, equal losses step for step (cuDNN
    held to deterministic algorithms for the pair)."""
    import shutil
    import tempfile

    import torch

    from pytorch_operator_tpu_torch.data import pack
    from pytorch_operator_tpu_torch.workloads import resnet_ab, resnet_bench

    from pytorch_operator_tpu_torch.models import resnet

    ab = resnet_ab.run_ab(device="cuda", log=_log, **AB_ARGS)
    plain, s2d = ab["plain"], ab["s2d"]
    gap = abs(plain["first_loss"] - s2d["first_loss"])
    torch.cuda.empty_cache()
    stem = resnet.SpaceToDepthStem.forward

    def wrong_regroup(self, x):
        n, c, h, w = x.shape
        return stem(self, x.reshape(n, c, h // 2, 2, w // 2, 2).transpose(3, 5).reshape(n, c, h, w))

    resnet.SpaceToDepthStem.forward = wrong_regroup
    try:
        fault = resnet_ab.run_ab(device="cuda", log=_log, variant_names=["s2d"], steps=1, rounds=1)
    finally:
        resnet.SpaceToDepthStem.forward = stem
    fault_gap = abs(plain["first_loss"] - fault["s2d"]["first_loss"])
    torch.cuda.empty_cache()
    _log(f"image (c) resnet_ab: plain {plain['images_per_sec_per_chip']}, s2d "
         f"{s2d['images_per_sec_per_chip']} images/sec/chip ({s2d['vs_first']}x); first-step losses "
         f"{plain['first_loss']:.6f} / {s2d['first_loss']:.6f}, gap {gap:.3e}; planted fault (a wrong s2d "
         f"regrouping) {fault['s2d']['first_loss']:.6f}, gap {fault_gap:.3e} (limit {S2D_FIRST_LOSS_ATOL:.0e})")
    if gap > S2D_FIRST_LOSS_ATOL:
        _fail("image (c): the s2d stem's first loss differs from the plain stem's")
    if fault_gap <= S2D_FIRST_LOSS_ATOL:
        _fail("image (c): the planted wrong s2d regrouping reads within the limit")
    td = tempfile.mkdtemp(prefix="chip_smoke_image_")
    deterministic = torch.backends.cudnn.deterministic
    try:
        f = f"{td}/syn112.bin"
        t0 = time.perf_counter()
        pack.main(FILE_PACK + ["--out", f])
        _log(f"image (c) packed {f}: {time.perf_counter() - t0:.1f} s")
        torch.backends.cudnn.deterministic = True
        runs = {p: resnet_bench.run_benchmark(device="cuda", data_file=f, prefetch=p, log=_log, **FILE_RUN)
                for p in (0, 2)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(td, ignore_errors=True)
    for p, r in runs.items():
        _log(f"image (c) file 112 px, prefetch {p}: {r['value']} images/sec/chip, losses "
             f"{[round(v, 5) for v in r['losses']]}")
    if runs[0]["losses"] != runs[2]["losses"] or runs[0]["input"] != "file":
        _fail("image (c): the prefetched file run's losses differ from the inline run's")
    torch.cuda.empty_cache()


def _image_world():
    """(d) ResNet-50 in two ranks sharing cuda:0 over gloo (global batch
    norm) against one process, global B64."""
    import torch

    from pytorch_operator_tpu_torch.workloads import resnet_bench

    t0 = time.perf_counter()
    # One world (a world's start-up is ~10 s): the sound run, then the
    # planted per-rank batch norm.
    outs = _rank_world("resnet", "(d) ResNet-50 two ranks, then per-rank batch norm planted",
                       then_per_rank_bn=True, **IMAGE_WORLD_RUN)
    fault = outs[0]["fault"]
    one = resnet_bench.run_benchmark(device="cuda", log=_log, **IMAGE_WORLD_RUN)
    torch.cuda.empty_cache()
    two = outs[0]["result"]
    n = WORLD_CHECK_STEPS
    gap, fault_gap = (max(abs(a - b) for a, b in zip(r["losses"][:n], one["losses"][:n]))
                      for r in (two, fault))
    _log(f"image (d) two ranks sharing one card (backend {outs[0]['backend']}): {two['value'] * 2:.1f} "
         f"images/sec, step {two['step_time_ms']} ms, losses {[round(v, 6) for v in two['losses']]}; one "
         f"process {one['value']} images/sec, step {one['step_time_ms']} ms, losses "
         f"{[round(v, 6) for v in one['losses']]}: largest gap of steps 1-{n} {gap:.3e}; planted fault "
         f"(per-rank batch norm) losses {[round(v, 6) for v in fault['losses']]}, gap {fault_gap:.3e} (limit "
         f"{WORLD_LOSS_ATOL:.1e}); {time.perf_counter() - t0:.1f} s")
    if (two["devices"], outs[1]["result"]["losses"]) != (2, two["losses"]) or gap > WORLD_LOSS_ATOL:
        _fail("image (d): the two-rank losses differ from one process's or between the ranks")
    if fault_gap <= WORLD_LOSS_ATOL:
        _fail("image (d): the planted per-rank batch norm reads within the limit")


def _vit_losses(attn_impl: str, dtype) -> list:
    """``VIT_CHECK_STEPS`` losses of ViT-B/16 trained as ``vit_bench`` trains
    it (seed-0 weights, its synthetic B128 x 224 px batch, AdamW), in
    ``dtype``."""
    import torch

    from pytorch_operator_tpu_torch.models import vit
    from pytorch_operator_tpu_torch.workloads import vit_bench

    x, y = _image_batch(128, 224)
    model = vit.ViT(vit.vit_b16(attn_impl=attn_impl, dtype=dtype), device="cuda")
    step, _ = vit_bench.make_train_step(model, lr=1e-3)
    x, y = x.to(torch.bfloat16).to(dtype).cuda(), y.cuda()
    losses = [float(step(x, y)) for _ in range(VIT_CHECK_STEPS)]
    del model, step
    torch.cuda.empty_cache()
    return losses


def _image_vit(kernels):
    """(e) vit_bench dense, then flash with the launch counts set to 0 just
    before and read just after (each kernel once a layer a step); flash's
    losses against dense's after the head has moved, beside dense bf16's
    drift from f32 and a planted fault (the padded keys attended)."""
    import torch

    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import vit_bench

    dense = vit_bench.run_benchmark(device="cuda", attn_impl="dense", log=_log, **VIT_RUN)
    torch.cuda.empty_cache()
    fa.reset_launch_count()
    flash = vit_bench.run_benchmark(device="cuda", attn_impl="flash", log=_log, **VIT_RUN)
    launches = fa.launch_counts()
    torch.cuda.empty_cache()
    _record_launches(kernels, "vit_flash", launches)
    steps = len(flash["losses"])
    for name, r in (("dense", dense), ("flash", flash)):
        step_ms = 1000 * r["global_batch"] / (r["value"] * r["devices"])
        _log(f"image (e) ViT-B/16 {name} B{r['global_batch']} x 224 px: {r['value']} images/sec/chip "
             f"(min fenced window {r['min_window_images_per_sec_per_chip']}), step {step_ms:.1f} ms, peak "
             f"memory {r['peak_mem_bytes'] / 2**30:.2f} GiB, losses {r['losses'][0]:.4f} -> "
             f"{r['final_loss']}, {len(r['losses'])} steps")
    f32 = _vit_losses("dense", torch.float32)
    launch = fa._launch
    fa._launch = lambda q, k, v, *, causal, kv_len, scale: launch(
        q, k, v, causal=causal, kv_len=q.shape[1], scale=scale)
    try:
        fault = _vit_losses("flash", torch.bfloat16)
    finally:
        fa._launch = launch
    n = VIT_CHECK_STEPS
    ref = dense["losses"][:n]

    def gap(losses):
        return max(abs(a - b) for a, b in zip(losses[1:n], ref[1:n]))

    reads = {"flash": gap(flash["losses"]), "dense f32 (drift)": gap(f32),
             "planted fault (padded keys attended)": gap(fault)}
    _log(f"image (e) losses of steps 1-{n}: dense {[round(v, 6) for v in ref]}, flash "
         f"{[round(v, 6) for v in flash['losses'][:n]]}, dense f32 {[round(v, 6) for v in f32]}, fault "
         f"{[round(v, 6) for v in fault]}; largest gap from dense bf16 over steps 2-{n}: "
         + ", ".join(f"{k} {v:.3e}" for k, v in reads.items()) + f" (limit {VIT_LOSS_ATOL:.0e})")
    _log(f"image (e) flash launches over {steps} steps: {launches} (want {VIT_LAYERS} a step each)")
    if launches != dict.fromkeys(launches, VIT_LAYERS * steps):
        _fail(f"image (e): the flash run launched {launches}, not {VIT_LAYERS} a step each")
    if reads["flash"] > VIT_LOSS_ATOL or not all(math.isfinite(v) for v in flash["losses"]):
        _fail("image (e): the flash losses differ from dense's, or a loss is not finite")
    if reads["planted fault (padded keys attended)"] <= VIT_LOSS_ATOL:
        _fail("image (e): the planted fault (padded keys attended) reads within the limit")


def _image_latency():
    """(f) latency_probe started twice as the supervisor starts a replica
    (n = 1) with a status dir: launch -> first step, and its phases."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory(prefix="chip_smoke_latency_") as td:
        for label in ("cold", "second"):
            status = Path(td) / label
            status.mkdir()
            t_launch = time.time()
            _run_world([sys.executable, "-m", "pytorch_operator_tpu_torch.workloads.latency_probe"],
                       f"(f) latency probe, {label}", n=1, env={"TPUJOB_STATUS_DIR": str(status)})
            recs = [json.loads(x) for x in (status / "master-0.jsonl").read_text().splitlines()]
            first = [r for r in recs if r["event"] == "first_step"]
            phases = [r for r in recs if r["event"] == "latency_phases"]
            if len(first) != 1 or len(phases) != 1:
                _fail(f"image (f) {label}: records {recs}")
            p = phases[0]
            _log(f"image (f) latency probe {label}: launch -> first step {first[0]['ts'] - t_launch:.3f} s "
                 f"(launch -> main entry {p['main_entry'] - t_launch:.3f} s; rendezvous "
                 f"{p['rendezvous_s']} s, import torch {p['import_torch_s']} s, CUDA context "
                 f"{p['client_init_s']} s, first step {p['first_exec_s']} s)")


IMAGE_PARTS = ("conv", "bn_elementwise", "gemm", "attention")


def _image_part(name: str, kernel: str) -> str:
    """The part of an image step a kernel belongs to, by the op that launched
    it: convs (their layout copies included), 2-D GEMMs (``mm``/``addmm``:
    the Linear layers), attention (the flash kernels, and dense attention's
    batched products and softmax), and the rest (batch and layer norms, the
    activations, pooling, the loss, the optimizer's updates)."""
    if "flash_" in kernel or "bmm" in name or "softmax" in name:
        return "attention"
    if "conv" in name:
        return "conv"
    if name in ("aten::mm", "aten::addmm"):
        return "gemm"
    return "bn_elementwise"


def _profile_image_steps():
    """One profiled training step of the ResNet-50 headline and of ViT-B/16
    flash (B128 x 224 px): the card's busy time split by :data:`IMAGE_PARTS`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_operator_tpu_torch.models import vit
    from pytorch_operator_tpu_torch.workloads import resnet_bench, vit_bench

    x, y = _image_batch(128, 224)
    x, y = x.cuda().to(torch.bfloat16), y.cuda()
    builds = {
        "ResNet-50": lambda: resnet_bench.make_train_step(
            resnet_bench.build_model(50, classes=1000, device="cuda"), lr=0.1, momentum=0.9)[0],
        "ViT-B/16 flash": lambda: vit_bench.make_train_step(
            vit.ViT(vit.vit_b16(attn_impl="flash"), device="cuda"), lr=1e-3)[0],
    }
    for what, build in builds.items():
        step = build()
        float(step(x, y))
        float(step(x, y))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(step(x, y))
            wall = time.perf_counter() - t0
        busy, _ = _report_profile(prof, wall, f"one {what} training step (B128 x 224 px)", top=10)
        split = dict.fromkeys(IMAGE_PARTS, 0.0)
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CPU or getattr(e, "is_user_annotation", False):
                continue
            for k in e.kernels:
                split[_image_part(e.name, k.name)] += k.duration / 1e3
        busy_ms = 1e3 * busy
        _log(f"image profile {what}: busy {busy_ms:.2f} ms: " + ", ".join(
            f"{k} {v:.2f} ms ({100 * v / busy_ms:.1f}%)" for k, v in split.items())
            + f"; charged {sum(split.values()):.2f} ms")
        del step, prof
        torch.cuda.empty_cache()


def phase_image(kernels):
    """Phase 12: (a) card against CPU with planted faults; (b) the ResNet-50
    headline; (c) resnet_ab and a packed file; (d) a two-rank world; (e)
    ViT-B/16 dense and flash; (f) the latency probe. Returns the profiles
    of one ResNet-50 and one ViT step, to run with the other profiles."""
    for part, run in (("(a)", _image_card_vs_cpu), ("(b)", _image_headline),
                      ("(c)", _image_ab_and_file), ("(d)", _image_world),
                      ("(e)", lambda: _image_vit(kernels)), ("(f)", _image_latency)):
        t0 = time.perf_counter()
        run()
        _log(f"image {part}: {time.perf_counter() - t0:.1f} s")
    return _profile_image_steps


# Phase 13: tensor parallelism and adafactor under a mesh. Two (in (c) four)
# ranks share cuda:0 over gloo, as in phase 11: the path and its numerics,
# not scaling. Each world runs its runs in one pair of processes.
# (a) at 4 of 0.3b's 16 layers (the script's budget: 1,064.6 s with it at
# 16 layers; PERF.md §7).
# 2 layers, for the script's time limit.
TP_RUN = dict(config="0.3b", n_layers=2, batch_size=4, seq_len=2048, warmup=1, steps=3)
# (b) at 2 layers too: gloo's fsdp=2 traffic is the step.
TP_ADA_RUN = dict(TP_RUN, optimizer="adafactor", lr=ADAFACTOR_LR)
TP_FOUR_RUN = dict(config="0.3b", n_layers=4, batch_size=4, seq_len=2048, warmup=1, steps=1)
TP_8B_RUN = dict(config="8b", batch_size=1, seq_len=2048, warmup=1, steps=1, param_dtype="bfloat16",
                 optimizer="adafactor", lr=ADAFACTOR_LR, remat=True, remat_policy="full")
# The world's losses against one process's over every step, in nats (the
# largest absolute difference), for (a) and (b). Readings on the NVIDIA H100
# 80GB HBM3 at 700 W: tp=2 2.7e-4, fsdp=2 adafactor 3.7e-4 (f32) and 7.8e-4
# (bf16); the planted leave fault 4.67.
TP_LOSS_ATOL = 5e-3
# (b): the parameters adafactor moves, against one process's: the relative
# L2 error of the move of the tensors below (their row statistics are split
# by fsdp), held between the sound reading and the planted unreduced-row
# fault's on the card (the losses of four steps barely show that fault:
# the row factor is normalised by its own mean). Readings on the NVIDIA
# H100 80GB HBM3 at 700 W: sound 5.9e-3 at 16 layers, 3.3e-3 at 8, 1.9e-3
# at 4; the fault 3.9e-2, 4.1e-2 and 4.2e-2.
TP_ADA_TENSORS = ["lm_head.weight", "layers.0.mlp.gate_proj.weight"]
TP_ADA_MOVE_RTOL = 1.5e-2
# (d): the first loss of random weights sits near ln V (the head's logits
# have about unit variance, which adds about half a nat).
TP_8B_FIRST_LOSS_ATOL = 1.0


def _planted(name):
    """A context in which a planted fault replaces the port's code (None:
    none), as ``tests/torch_worlds.planted`` plants it on the CPU (the card's
    machine has its own ``tests`` package, so this script keeps a copy):
    ``"leave_psum_autograd"``, tp's leave whose backward sums over tp too
    (every gradient upstream multiplied by tp); ``"unreduced_rows"``,
    adafactor's row statistics left unreduced over the axes that split the
    dim they reduce; ``"ring_local_positions"``, the ring attention masking
    by each rank's local positions (rank 0 sees later blocks, the others
    lose earlier ones); ``"ep_leave_psum_autograd"``, the MoE layer's leave
    over ep written with ``psum_autograd`` (the experts' upstream gradients
    multiplied by ep); ``"moe_rank_groups"``, sparse MoE dispatch grouping
    each rank's own tokens (the groups the reference forms over every rank's
    tokens not formed); ``"pp_shifted_cotangent"``, each pipeline stage
    backwarding a microbatch's stored graph with the previous microbatch's
    cotangent (the first with its own); ``"ulysses_sp_heads"``, ulysses
    under tp keeping, of the global heads' output, the block at the rank's
    sp coordinate instead of its tp coordinate; ``"pp_tp_outer_head"``, the
    seeded init taking each rank's blocks with the axes nested tp outer, pp
    inner (the head's rows of stage s, tp rank t at ``t·V/tp + s·V/(tp·P)``)
    while the loss's column offset stays pp-outer; ``"bert_bias_every_rank"``,
    BERT's row-parallel products (o_proj, mlp_down) adding the whole bias on
    every tp rank before the sum; ``"pp_coordinate_rows"``, the feed giving
    each data coordinate its own consecutive rows of the global batch
    whatever its microbatches (a pipeline microbatch then splits those rows,
    not the reference's global batch)."""
    import contextlib

    @contextlib.contextmanager
    def patch():
        if name is None:
            yield
            return
        from pytorch_operator_tpu_torch.models import llama as llama_lib
        from pytorch_operator_tpu_torch.parallel import collectives, moe
        from pytorch_operator_tpu_torch.workloads import trainer

        if name == "pp_shifted_cotangent":
            from pytorch_operator_tpu_torch.parallel import pipeline

            where, attr = pipeline._Stage, "backward"
            sound_backward = pipeline._Stage.backward

            def fault(self, j, cot):
                prev, self.prev_cot = getattr(self, "prev_cot", None), cot
                return sound_backward(self, j, cot if prev is None else prev)
        elif name == "ring_local_positions":
            where, attr = llama_lib, "ring_attention_shard"
            sound = llama_lib.ring_attention_shard

            def fault(q, k, v, q_pos, kv_pos, **kw):
                return sound(q, k, v, q_pos - q_pos[:, :1], kv_pos - kv_pos[:, :1], **kw)
        elif name == "ep_leave_psum_autograd":
            where, attr = moe, "tp_leave"
            fault = lambda x, axis, mesh=None: collectives.psum_autograd(x, axis, mesh)  # noqa: E731
        elif name == "moe_rank_groups":
            where, attr = llama_lib, "moe_mlp_sparse"
            sound_sparse = llama_lib.moe_mlp_sparse

            def fault(params, x, tokens=None, **kw):
                return sound_sparse(params, x, **kw)
        elif name == "ulysses_sp_heads":
            from pytorch_operator_tpu_torch.parallel import ulysses

            where, attr = ulysses, "own_heads"

            def fault(out, n, axis, mesh):
                return out.narrow(2, collectives.axis_index("sp", mesh) * n, n)
        elif name == "pp_tp_outer_head":
            from pytorch_operator_tpu_torch.parallel import sharding

            where, attr = llama_lib, "take_block"

            def fault(t, splits):
                for ax, d in sharding.cut_splits(splits):
                    t = t.narrow(d, *ax.block(t.shape[d], "a planted block"))
                return t
        elif name == "bert_bias_every_rank":
            import torch.nn.functional as F

            from pytorch_operator_tpu_torch.models import bert

            where, attr = bert, "row_parallel"

            def fault(dense, x, tp):
                dt = dense.compute_dtype
                return dense(x) if tp is None else tp.leave(
                    F.linear(x.to(dt), dense.weight.to(dt), dense.bias.to(dt)))
        elif name == "pp_coordinate_rows":
            from pytorch_operator_tpu_torch.parallel import data

            where, attr = data, "global_batch"
            sound_rows = data.global_batch

            def fault(batch, process_index=None, process_count=None, microbatches=1):
                return sound_rows(batch, process_index, process_count)
        elif name == "leave_psum_autograd":
            where, attr = collectives, "tp_leave"
            fault = lambda x, axis="tp", mesh=None: collectives.psum_autograd(x, axis, mesh)  # noqa: E731
        elif name == "unreduced_rows":
            where, attr = trainer.Adafactor, "_mean"
            sound = trainer.Adafactor._mean

            def fault(self, x, dims, lay, leaf_dims, keepdim=False):
                factored = trainer._factored_dims(lay.whole)
                if factored is not None and list(leaf_dims) == [factored[1]] and not keepdim:
                    return x.mean(dims)
                return sound(self, x, dims, lay, leaf_dims, keepdim)
        else:
            raise ValueError(f"no planted fault {name!r}")
        saved = getattr(where, attr)
        setattr(where, attr, fault)
        try:
            yield
        finally:
            setattr(where, attr, saved)

    return patch()


def _tp_bytes(config: str, param_dtype: str, tp: int, **over) -> tuple:
    """``(params, bytes a rank)`` of ``config`` (with ``over``) under ``tp``:
    the split tensors' share plus the whole norms (f32), from a model on the
    meta device."""
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.parallel.sharding import tp_dim

    cfg = getattr(llama_lib, llama_lib.CONFIGS[config])(param_dtype=getattr(torch, param_dtype), **over)
    model = llama_lib.Llama(cfg, device="meta")
    total = sum(p.numel() for p in model.parameters())
    mine = sum(p.numel() * p.element_size() // (tp if tp_dim(n) is not None else 1)
               for n, p in model.named_parameters())
    return total, mine


def _seeded_tensors(config: str, n_layers: int, names, **over) -> dict:
    """``names``' tensors of ``llama_train``'s seed-0 init of ``config``
    at ``n_layers`` (and the config's ``over``) on the card, as CPU
    tensors."""
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib

    cfg = getattr(llama_lib, llama_lib.CONFIGS[config])(n_layers=n_layers, **over)
    model = llama_lib.Llama(cfg, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    sd = model.state_dict()
    out = {name: sd[name].detach().cpu() for name in names}
    del model, sd
    torch.cuda.empty_cache()
    return out


def _move_error(got: dict, want: dict, init: dict) -> float:
    """The largest over the tensors of ``||got − want|| / ||want − init||``:
    how far a run's parameter moves are from the reference's."""
    return max(float((got[n].float() - want[n].float()).norm() / (want[n].float() - init[n].float()).norm())
               for n in want)


def _loss_gap(a, b) -> float:
    return max(abs(x - y) for x, y in zip(a, b))


def _tp_launches(kernels, path: str, results, total_steps: int, n_layers: int, remat: bool) -> None:
    """Each rank launched each kernel once a layer a step (the forward
    twice under remat); the ranks' sum into the kernels line under
    ``path``."""
    want = {k: v * total_steps for k, v in _per_step(n_layers, remat).items()}
    summed = {k: 0 for k in want}
    for r in results:
        if r["flash_launches"] != want:
            _fail(f"tp {path}: rank {r['rank']} launched {r['flash_launches']}, expected {want}")
        for k, v in r["flash_launches"].items():
            summed[k] += v
    _record_launches(kernels, path, summed)


def _tp_describe(tag: str, r: dict) -> None:
    per = r["per_rank"]
    _log(
        f"tp {tag}: mesh {r['mesh']}, {r['value'] * r['world']:.1f} tokens/s over {r['world']} ranks "
        f"sharing one card, step {r['step_s']:.4f} s, losses {[round(x, 5) for x in r['losses']]}; per "
        f"rank (data, tp) {[(q['data_index'], q['tp_index']) for q in per]}, param bytes "
        f"{[q['param_bytes'] for q in per]}, optimizer bytes {[q['optimizer_state_bytes'] for q in per]}, "
        f"peak memory GiB {[round((q['peak_mem_bytes'] or 0) / 2**30, 2) for q in per]}"
    )


def _tp_four_checks(kernels, outs, ck) -> None:
    """Phase 13(c)'s checks of its run (``outs``' first, run in phase 15's
    world of four ranks): fsdp=2,tp=2 at 4 layers, the ranks' coordinates,
    launches and gathered parameters against the checkpoint in ``ck``
    restored by one process."""
    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager

    r = outs[0]["runs"][0]["result"]
    _tp_describe("(c) fsdp=2,tp=2", r)
    four_total = TP_FOUR_RUN["warmup"] + TP_FOUR_RUN["steps"]
    _tp_launches(kernels, "tp_0.3b_fsdp2_tp2", r["per_rank"], four_total, 4, remat=False)
    step, params = CheckpointManager(ck, create=False).restore_subtree("params")
    restored = _params_digest(params.items())
    del params
    digests = {o["runs"][0]["params"] for o in outs}
    _log(f"tp (c): step {step} restored by one process, digest {restored}; the four ranks' "
         f"gathered parameters {sorted(digests)}; the run {outs[0]['runs'][0]['wall_s']:.1f} s on rank 0")
    if step != four_total or digests != {restored}:
        _fail("tp (c): the one-process restore differs from the ranks' gathered parameters")
    if [(q["data_index"], q["tp_index"]) for q in r["per_rank"]] != [(0, 0), (0, 1), (1, 0), (1, 1)]:
        _fail(f"tp (c): rank coordinates {r['per_rank']}")


# Phases 13(a), (b), (d), 14(a)-(b) and 15(a)-(d) run in one world of two
# ranks (a world's start-up costs ~10-12 s of the script's limit): the
# first of phases 13 and 14 to run starts it, and each phase takes its runs'
# outputs from here (15's through _PP_WORLD) with the directory its saves
# went to.
_WORLD2 = {}


def _two_rank_world() -> None:
    """The runs of phases 13(a), (b), (d), 14(a)-(b) and 15(a)-(d) in one
    world of two ranks, in that order: 13's tp=2 pair (sound and the
    planted leave fault), fsdp=2 adafactor f32, bf16 and the unreduced-row
    fault, Llama-3-8B at tp=2; 14's sp=2 ring, its planted fault and
    ulysses, ep=2 dense, sparse and the planted leave fault, the sparse
    token groups and their planted fault; 15's pp=2 runs."""
    import tempfile
    from pathlib import Path

    tdb_tp = tempfile.mkdtemp(prefix="chip_smoke_tp_b_")
    tdb_ep = tempfile.mkdtemp(prefix="chip_smoke_ep_")
    pp_dir = tempfile.mkdtemp(prefix="chip_smoke_pp_")
    tp_runs = [
        dict(TP_RUN, mesh_spec="tp=2"), dict(TP_RUN, mesh_spec="tp=2", plant="leave_psum_autograd"),
        dict(TP_ADA_RUN, mesh_spec="fsdp=2", param_dtype="float32",
             save=[f"{tdb_tp}/sound.pt", TP_ADA_TENSORS]),
        dict(TP_ADA_RUN, mesh_spec="fsdp=2", param_dtype="bfloat16"),
        dict(TP_ADA_RUN, mesh_spec="fsdp=2", param_dtype="float32", plant="unreduced_rows",
             save=[f"{tdb_tp}/fault.pt", TP_ADA_TENSORS]),
        dict(TP_8B_RUN, mesh_spec="tp=2"),
    ]
    sp_ep_runs = [
        dict(SP_RUN, mesh_spec="sp=2", attn_impl="ring", digest=True),
        dict(SP_RUN, mesh_spec="sp=2", attn_impl="ring", plant="ring_local_positions"),
        dict(SP_RUN, mesh_spec="sp=2", attn_impl="ulysses", digest=True),
        dict(EP_RUN, mesh_spec="ep=2", save=[f"{tdb_ep}/sound.pt", EP_MOVE_TENSORS]),
        dict(EP_RUN, mesh_spec="ep=2", **EP_SPARSE),
        dict(EP_RUN, mesh_spec="ep=2", plant="ep_leave_psum_autograd",
             save=[f"{tdb_ep}/fault.pt", EP_MOVE_TENSORS]),
        dict(EP_GROUPS, mesh_spec="fsdp=2"),
        dict(EP_GROUPS, mesh_spec="sp=2", attn_impl="ring"),
        dict(EP_GROUPS_ACCUM, mesh_spec="fsdp=2"),
        dict(EP_GROUPS, mesh_spec="fsdp=2", plant="moe_rank_groups"),
    ]
    pp_runs = _pp_world_runs(Path(pp_dir) / "ck")
    outs = _rank_world("runs", "13(a), (b), (d) tp=2 and fsdp=2, 14(a)-(b) sp=2 and ep=2, 15(a)-(d) pp=2",
                       runs=[*tp_runs, *sp_ep_runs, *pp_runs])
    _log(f"13(a), (b), (d), 14(a)-(b), 15(a)-(d): the world's runs took "
         f"{[round(r['wall_s'], 1) for r in outs[0]['runs']]} s on rank 0")

    def part(start: int, stop: int) -> list:
        return [{**o, "runs": o["runs"][start:stop]} for o in outs]

    n_tp, n_sp_ep = len(tp_runs), len(sp_ep_runs)
    _WORLD2.update(tp=(part(0, n_tp), tdb_tp), sp_ep=(part(n_tp, n_tp + n_sp_ep), tdb_ep))
    _PP_WORLD.update(dir=pp_dir, outs=part(n_tp + n_sp_ep, len(outs[0]["runs"])))


def phase_tp(kernels):
    """Phase 13: (a) 0.3b at tp=2 against one process, and the planted
    leave fault; (b) 0.3b at fsdp=2 with adafactor in f32 and bf16 against
    one process's adafactor, and the planted unreduced-row fault; (c) 0.3b
    at 4 layers on four ranks, fsdp=2,tp=2, its checkpoint restored by one
    process (in phase 15's world, :func:`_tp_four_checks`); (d) Llama-3-8B's full width at tp=2, bf16, adafactor, remat.
    The kernels at the per-rank shapes (B4 S2048 H4 KH2, B1 S2048 H16 KH4)
    are held and timed in phases 2-3."""
    import shutil

    import torch

    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import llama_train

    torch.cuda.empty_cache()
    total = TP_RUN["warmup"] + TP_RUN["steps"]
    n_layers = TP_RUN["n_layers"]

    # The one-process references of (a) and (b), then (a), (b) and (d) in
    # the world of two ranks that phases 14 and 15 share
    # (:func:`_two_rank_world`).
    t0 = time.perf_counter()
    fa.reset_launch_count()
    one = llama_train.run(device="cuda", log=_log, **TP_RUN)
    _record_launches(kernels, "tp_one_process", fa.launch_counts())
    torch.cuda.empty_cache()
    ones = {}
    for dtype in ("float32", "bfloat16"):
        fa.reset_launch_count()
        ones[dtype] = llama_train.run(device="cuda", log=_log, param_dtype=dtype,
                                      keep_params=dtype == "float32", **TP_ADA_RUN)
        _record_launches(kernels, f"tp_adafactor_one_{dtype}", fa.launch_counts())
        torch.cuda.empty_cache()
    whole = ones["float32"].pop("params")
    one_params = {name: whole[name] for name in TP_ADA_TENSORS}
    del whole
    init = _seeded_tensors("0.3b", TP_ADA_RUN["n_layers"], TP_ADA_TENSORS)
    if "tp" not in _WORLD2:
        _two_rank_world()
    tp_world, tdb = _WORLD2.pop("tp")
    try:
        moved = {tag: _move_error(torch.load(f"{tdb}/{tag}.pt"), one_params, init)
                 for tag in ("sound", "fault")}
    finally:
        shutil.rmtree(tdb, ignore_errors=True)
    sound, fault = (tp_world[0]["runs"][i]["result"] for i in (0, 1))
    _tp_describe("(a) tp=2", sound)
    _tp_launches(kernels, "tp_0.3b_tp2", sound["per_rank"], total, n_layers, remat=False)
    gap, fault_gap = _loss_gap(sound["losses"], one["losses"]), _loss_gap(fault["losses"], one["losses"])
    n_params, want_bytes = _tp_bytes("0.3b", "float32", 2, n_layers=n_layers)
    _log(
        f"tp (a): one process {[round(x, 5) for x in one['losses']]}, step {one['step_s']:.4f} s, "
        f"param bytes {one['param_bytes']}, peak {(one['peak_mem_bytes'] or 0) / 2**30:.2f} GiB; "
        f"tp=2 losses within {gap:.3e} (limit {TP_LOSS_ATOL:.0e}); planted leave fault "
        f"{fault_gap:.3e} ({[round(x, 5) for x in fault['losses']]}); param bytes a rank want "
        f"{want_bytes}; {time.perf_counter() - t0:.1f} s"
    )
    if gap > TP_LOSS_ATOL or fault_gap <= TP_LOSS_ATOL:
        _fail(f"tp (a): tp=2 losses {gap:.3e} from one process's, the leave fault {fault_gap:.3e} "
              f"(limit {TP_LOSS_ATOL:.0e})")
    if any(q["param_bytes"] != want_bytes for q in sound["per_rank"]) or (
        sound["world"], sound["backend"], sound["mesh"]) != (2, "gloo", {"tp": 2}):
        _fail(f"tp (a): per-rank bytes, world, backend or mesh wrong: {sound['per_rank']}")

    # (b) fsdp=2 with adafactor, f32 and bf16, against one process's; the
    # planted unreduced-row fault, read on two tensors whose row statistics
    # fsdp splits (the head's over the vocabulary, gate's over d_ff).
    t0 = time.perf_counter()
    _log(f"tp (b): the parameters' moves against one process's, relative L2 (largest of "
         f"{TP_ADA_TENSORS}): sound {moved['sound']:.3e}, planted unreduced rows "
         f"{moved['fault']:.3e} (limit {TP_ADA_MOVE_RTOL:.1e})")
    if moved["sound"] > TP_ADA_MOVE_RTOL or moved["fault"] <= TP_ADA_MOVE_RTOL:
        _fail(f"tp (b): the moves differ from one process's by {moved['sound']:.3e}, the fault's "
              f"by {moved['fault']:.3e} (limit {TP_ADA_MOVE_RTOL:.1e})")
    runs = [r["result"] for r in tp_world[0]["runs"][2:5]]
    for dtype, r in zip(("float32", "bfloat16"), runs):
        _tp_describe(f"(b) fsdp=2 adafactor {dtype}", r)
        _tp_launches(kernels, f"tp_adafactor_fsdp2_{dtype}", r["per_rank"], total,
                     TP_ADA_RUN["n_layers"], remat=False)
        g = _loss_gap(r["losses"], ones[dtype]["losses"])
        _log(f"tp (b) {dtype}: one process {[round(x, 5) for x in ones[dtype]['losses']]}, state "
             f"bytes {ones[dtype]['optimizer_state_bytes']}; fsdp=2 within {g:.3e} (limit "
             f"{TP_LOSS_ATOL:.0e})")
        if g > TP_LOSS_ATOL:
            _fail(f"tp (b) {dtype}: fsdp=2 adafactor losses {g:.3e} from one process's")
        if not all(0 < q["optimizer_state_bytes"] < ones[dtype]["optimizer_state_bytes"] for q in r["per_rank"]):
            _fail(f"tp (b) {dtype}: a rank's adafactor state is not a part of one process's")
    fault_gap = _loss_gap(runs[2]["losses"], ones["float32"]["losses"])
    _log(f"tp (b): planted unreduced-row fault's losses {fault_gap:.3e} from one process's "
         f"({[round(x, 5) for x in runs[2]['losses']]}); {time.perf_counter() - t0:.1f} s")

    # (c), four ranks at fsdp=2,tp=2, runs in phase 15's world of four
    # ranks (_pp_beside, _tp_four_checks): a world's start-up is time of
    # the script's limit.

    # (d) Llama-3-8B's full width at tp=2 (run in (a)'s world).
    t0 = time.perf_counter()
    r = tp_world[0]["runs"][5]["result"]
    _tp_describe("(d) Llama-3-8B tp=2", r)
    total_8b = TP_8B_RUN["warmup"] + TP_8B_RUN["steps"]
    _tp_launches(kernels, "tp_8b_tp2", r["per_rank"], total_8b, 32, remat=True)
    n_8b, want_8b = _tp_bytes("8b", "bfloat16", 2)
    first = r["losses"][0]
    _log(f"tp (d): params_m {r['params_m']} (whole model {n_8b}), first loss {first:.4f} against ln "
         f"128256 = {math.log(128256):.4f}, param bytes a rank want {want_8b}; "
         f"{time.perf_counter() - t0:.1f} s")
    if not all(math.isfinite(x) for x in r["losses"]) or abs(first - math.log(128256)) > TP_8B_FIRST_LOSS_ATOL:
        _fail(f"tp (d): losses {r['losses']}")
    if r["params_m"] != round(n_8b / 1e6, 1) or any(q["param_bytes"] != want_8b for q in r["per_rank"]):
        _fail(f"tp (d): params_m {r['params_m']} or per-rank bytes {r['per_rank']}")
    return None


# Phase 14: sequence and expert parallelism. (a) at B2 x 8192, not 16384:
# ulysses keeps each layer's [B, K/sp, G, S, S] f32 probabilities for the
# backward (8.6 GB a layer a rank at 16384, 69 GB for the two ranks' 4
# layers beside their other state on one card), and the one-process
# reference's shape is held against the plain kernels in phases 2-3 (17 GB
# of f32 scores at 16384).
# 2 layers and 1 + 1 steps, for the script's time limit (the planted fault
# reads 2.4e-2 at the second step).
SP_RUN = dict(config="0.3b", n_layers=2, batch_size=2, seq_len=8192, warmup=1, steps=1)
EP_RUN = dict(config="0.3b", n_layers=4, batch_size=8, seq_len=2048, warmup=1, steps=3,
              n_experts=8, moe_top_k=2, attn_impl="flash")
EP_SPARSE = dict(moe_dispatch="sparse", moe_aux_weight=1e-2)
# (b)'s sparse dispatch over token groups that cross ranks: EP_RUN's model
# at B2 x 512 (N 1,024, one group, that fsdp=2 splits by rows and sp=2 by
# blocks) and B4 x 512 in two microbatches (a group each), at capacity 0.5:
# about half the routings drop, which ones set by the group's global order.
# 1 + 2 steps (the script's time limit: an fsdp=2 step of the two ranks
# gathers and scatters the f32 parameters through the host under gloo).
EP_GROUPS = dict(EP_RUN, batch_size=2, seq_len=512, steps=2, moe_capacity_factor=0.5, **EP_SPARSE)
# The accumulating run at 2 layers, for the script's time limit (a step of
# the two fsdp ranks gathers and scatters the parameters through the host
# twice).
EP_GROUPS_ACCUM = dict(EP_GROUPS, batch_size=4, grad_accum=2, n_layers=2)
# Their losses and aux losses against one process's, in nats. At 1,024
# tokens a step the loss falls from about 11 to about 4.4 in two steps, and
# a world's bf16 noise, carried through routings that flip near a tie and
# another reduction order, grows with it to about 1e-2 by the third step
# (PERF.md §6; the ep=2 runs' 16,384 tokens a step stay within
# EP_LOSS_ATOL); each rank grouping its own tokens drops other routings
# and reads about 0.17. The limit sits a factor 3 from both.
GROUPS_LOSS_ATOL = 5e-2
# The worlds' losses against one process's over every step, in nats (the
# largest absolute difference). Predictions (PERF.md §6): sp 1e-4 to
# 2e-3 (the ring and ulysses attend in f32, the one process's flash rounds
# p to bf16), the planted local-position fault 1e-2 to 0.5; ep 1e-4 to
# 2e-3 (the experts' bf16 parts summed over ep by an all-reduce).
SP_LOSS_ATOL = 5e-3
EP_LOSS_ATOL = 5e-3
# (b): the planted ep fault doubles the gradient upstream of each MoE
# output, which AdamW's normalisation hides from four steps' losses (the
# experts' own gradients are only scaled); it shows in the moves of tensors
# whose gradients mix the doubled path with the residual one: relative L2
# against one process's move (predicted: sound 1e-3 to 2e-2, the fault 0.1
# to 0.3; the CPU's tiny f32 readings 1.5e-6 and 0.15).
EP_MOVE_TENSORS = ["layers.0.attn.q_proj.weight", "layers.0.moe_mlp.gate"]
EP_MOVE_RTOL = 5e-2
# (c) ulysses under tp over the global kv heads: 0.3b's 4 kv heads at tp=4
# leave one a tp rank, which sp=2 cannot split, so each rank gathers q, k
# and v over tp and swaps the global heads. Eight ranks share the card;
# global B8 x 2048 (the workload rounds the global batch up to a multiple
# of the ranks, as JAX's does; a rank's f32 scores a layer, [8, 2, 2, 2048,
# 2048], are B2 x 4096's), AdamW, 1 + 2 steps, held to SP_LOSS_ATOL against
# one process with flash (at MOE_SHAPE, held and timed in phases 2-3); 2
# layers and 1 + 1 steps, for the script's time limit (the planted fault
# reads 0.21 at the second step).
SP_TP_RUN = dict(config="0.3b", n_layers=2, batch_size=8, seq_len=2048, warmup=1, steps=1)
SP_TP_MESH = {"sp": 2, "tp": 4}


def _world_describe(tag: str, r: dict) -> None:
    per = r["per_rank"]
    _log(
        f"{tag}: mesh {r['mesh']}, {r['value'] * r['world']:.1f} tokens/s over {r['world']} ranks "
        f"sharing one card, step {r['step_s']:.4f} s, losses {[round(x, 5) for x in r['losses']]}; per "
        f"rank (data, sp, ep) {[(q['data_index'], q['sp_index'], q['ep_index']) for q in per]}, "
        f"param bytes {[q['param_bytes'] for q in per]}, expert bytes "
        f"{[q['expert_param_bytes'] for q in per]}, peak memory GiB "
        f"{[round((q['peak_mem_bytes'] or 0) / 2**30, 2) for q in per]}, flash launches "
        f"{[q['flash_launches'] for q in per]}"
    )


def phase_sp_ep(kernels):
    """Phase 14: (a) 0.3b at sp=2, ring and ulysses, against one process with
    the flash kernels, and the planted local-position fault; (b) the MoE
    Llama at ep=2, dense and sparse, against one process, and the planted
    ep leave fault; then sparse dispatch over token groups that cross ranks
    (fsdp=2, sp=2 ring, fsdp=2 with grad_accum=2) against one process, and
    the planted per-rank grouping; (c) 0.3b at sp=2,tp=4 with ulysses over
    the global kv heads (:func:`_sp_tp_part`). The kernels at (a)'s
    one-process shape (B2 S8192), at (b)'s per-rank shape (B8 S2048,
    ``MOE_SHAPE``), at the token groups' one-process shape (B2 S512,
    ``GROUPS_SHAPE``) and at (c)'s one-process shape (B8 S2048,
    ``MOE_SHAPE``) are held and timed in phases 2-3. (a) and (b) run in the
    world of two ranks that phases 13 and 15 share
    (:func:`_two_rank_world`)."""
    import shutil

    import torch

    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import llama_train

    torch.cuda.empty_cache()
    total = SP_RUN["warmup"] + SP_RUN["steps"]
    # The one-process references of (a) and (b); their world ran in phase 13.
    t0 = time.perf_counter()
    fa.reset_launch_count()
    one = llama_train.run(device="cuda", log=_log, attn_impl="flash", **SP_RUN)
    _record_launches(kernels, "sp_one_process", fa.launch_counts())
    torch.cuda.empty_cache()
    ones = {}
    for dispatch, over in (("dense", {}), ("sparse", EP_SPARSE)):
        fa.reset_launch_count()
        ones[dispatch] = llama_train.run(device="cuda", log=_log, keep_params=dispatch == "dense",
                                         **EP_RUN, **over)
        _record_launches(kernels, f"ep_one_{dispatch}", fa.launch_counts())
        torch.cuda.empty_cache()
    for tag, kw in (("groups", EP_GROUPS), ("groups_accum", EP_GROUPS_ACCUM)):
        fa.reset_launch_count()
        ones[tag] = llama_train.run(device="cuda", log=_log, **kw)
        _record_launches(kernels, f"ep_one_{tag}", fa.launch_counts())
        torch.cuda.empty_cache()
    whole = ones["dense"].pop("params")
    one_params = {name: whole[name] for name in EP_MOVE_TENSORS}
    del whole
    init = _seeded_tensors(EP_RUN["config"], EP_RUN["n_layers"], EP_MOVE_TENSORS,
                           n_experts=EP_RUN["n_experts"])
    if "sp_ep" not in _WORLD2:
        _two_rank_world()
    outs, tdb = _WORLD2.pop("sp_ep")
    try:
        moved = {tag: _move_error(torch.load(f"{tdb}/{tag}.pt"), one_params, init)
                 for tag in ("sound", "fault")}
    finally:
        shutil.rmtree(tdb, ignore_errors=True)
    ring, fault, uly = (outs[0]["runs"][i]["result"] for i in range(3))
    gaps = {tag: _loss_gap(r["losses"], one["losses"])
            for tag, r in (("ring", ring), ("fault", fault), ("ulysses", uly))}
    for tag, r in (("ring", ring), ("ulysses", uly)):
        _world_describe(f"sp (a) sp=2 {tag}", r)
        digests = {o["runs"][0 if tag == "ring" else 2]["params"] for o in outs}
        if len(digests) != 1:
            _fail(f"sp (a) {tag}: the sp ranks' parameters differ after the last step: {digests}")
        if any(any(q["flash_launches"].values()) for q in r["per_rank"]):
            _fail(f"sp (a) {tag}: a flash kernel launched on the sp path")
        if (r["world"], r["backend"], r["mesh"], len(r["losses"])) != (2, "gloo", {"sp": 2}, total):
            _fail(f"sp (a) {tag}: world, backend, mesh or step count wrong")
        if [(q["data_index"], q["sp_index"]) for q in r["per_rank"]] != [(0, 0), (0, 1)]:
            _fail(f"sp (a) {tag}: rank coordinates {r['per_rank']}")
        _record_launches(kernels, f"sp_{tag}_sp2", {k: 0 for k in fa.launch_counts()})
    _log(
        f"sp (a): one process (flash) {[round(x, 5) for x in one['losses']]}, step "
        f"{one['step_s']:.4f} s, peak {(one['peak_mem_bytes'] or 0) / 2**30:.2f} GiB; sp=2 ring within "
        f"{gaps['ring']:.3e}, ulysses within {gaps['ulysses']:.3e} (limit {SP_LOSS_ATOL:.0e}); planted "
        f"local-position fault {gaps['fault']:.3e} ({[round(x, 5) for x in fault['losses']]}); "
        f"{time.perf_counter() - t0:.1f} s"
    )
    if max(gaps["ring"], gaps["ulysses"]) > SP_LOSS_ATOL or gaps["fault"] <= SP_LOSS_ATOL:
        _fail(f"sp (a): losses from one process's {gaps} (limit {SP_LOSS_ATOL:.0e})")

    # (b) ep=2, dense then sparse, against one process; the planted leave
    # fault, read on the moves of two tensors upstream of the experts.
    runs = [r["result"] for r in outs[0]["runs"][3:6]]
    for dispatch, r in zip(("dense", "sparse"), runs):
        _world_describe(f"ep (b) ep=2 {dispatch}", r)
        _tp_launches(kernels, f"ep_{dispatch}_ep2", r["per_rank"], EP_RUN["warmup"] + EP_RUN["steps"],
                     EP_RUN["n_layers"], remat=False)
        g = _loss_gap(r["losses"], ones[dispatch]["losses"])
        half = ones[dispatch]["per_rank"][0]["expert_param_bytes"] // 2
        _log(f"ep (b) {dispatch}: one process {[round(x, 5) for x in ones[dispatch]['losses']]}, step "
             f"{ones[dispatch]['step_s']:.4f} s, expert bytes "
             f"{ones[dispatch]['per_rank'][0]['expert_param_bytes']}, peak "
             f"{(ones[dispatch]['peak_mem_bytes'] or 0) / 2**30:.2f} GiB; ep=2 within {g:.3e} (limit "
             f"{EP_LOSS_ATOL:.0e})")
        if g > EP_LOSS_ATOL:
            _fail(f"ep (b) {dispatch}: ep=2 losses {g:.3e} from one process's")
        if any(q["expert_param_bytes"] != half for q in r["per_rank"]):
            _fail(f"ep (b) {dispatch}: a rank's expert bytes are not half of one process's {2 * half}")
        if (r["n_experts"], r["moe_dispatch"], r["params_m"]) != (
            8, dispatch, ones[dispatch]["params_m"]
        ):
            _fail(f"ep (b) {dispatch}: n_experts, dispatch or params_m differ from one process's")
    fault_gap = _loss_gap(runs[2]["losses"], ones["dense"]["losses"])
    _log(f"ep (b): the moves of {EP_MOVE_TENSORS} against one process's, relative L2: sound "
         f"{moved['sound']:.3e}, planted ep leave fault {moved['fault']:.3e} (limit "
         f"{EP_MOVE_RTOL:.0e}); the fault's losses {fault_gap:.3e} from one process's")
    if moved["sound"] > EP_MOVE_RTOL or moved["fault"] <= EP_MOVE_RTOL:
        _fail(f"ep (b): the moves differ from one process's by {moved['sound']:.3e}, the fault's by "
              f"{moved['fault']:.3e} (limit {EP_MOVE_RTOL:.0e})")

    # (b) sparse dispatch over token groups that cross ranks, against one
    # process; the planted fault groups each rank's own tokens.
    fsdp, ring, accum, fault = (r["result"] for r in outs[0]["runs"][6:10])
    g_total = EP_GROUPS["warmup"] + EP_GROUPS["steps"]
    for tag, r, ref, mesh, coords, steps, run_kw in (
        ("(i) fsdp=2", fsdp, ones["groups"], {"fsdp": 2}, "data_index", g_total, EP_GROUPS),
        ("(ii) sp=2 ring", ring, ones["groups"], {"sp": 2}, "sp_index", g_total, EP_GROUPS),
        ("(iii) fsdp=2 grad_accum=2", accum, ones["groups_accum"], {"fsdp": 2}, "data_index", 2 * g_total,
         EP_GROUPS_ACCUM),
    ):
        _world_describe(f"ep (b) groups {tag}", r)
        gap, aux_gap = _loss_gap(r["losses"], ref["losses"]), _loss_gap(r["aux_losses"], ref["aux_losses"])
        _log(f"ep (b) groups {tag}: one process {[round(x, 5) for x in ref['losses']]} (aux "
             f"{[round(x, 5) for x in ref['aux_losses']]}), step {ref['step_s']:.4f} s; the world's "
             f"losses within {gap:.3e}, aux within {aux_gap:.3e} (limit {GROUPS_LOSS_ATOL:.0e})")
        if max(gap, aux_gap) > GROUPS_LOSS_ATOL:
            _fail(f"ep (b) groups {tag}: losses {gap:.3e}, aux {aux_gap:.3e} from one process's")
        if (r["world"], r["mesh"], len(r["losses"])) != (2, mesh, g_total):
            _fail(f"ep (b) groups {tag}: world, mesh or step count wrong")
        if [q[coords] for q in r["per_rank"]] != [0, 1]:
            _fail(f"ep (b) groups {tag}: rank coordinates {r['per_rank']}")
        if tag.startswith("(ii)"):
            if any(any(q["flash_launches"].values()) for q in r["per_rank"]):
                _fail(f"ep (b) groups {tag}: a flash kernel launched on the ring path")
            _record_launches(kernels, "ep_groups_sp2_ring", {k: 0 for k in fa.launch_counts()})
        else:
            _tp_launches(kernels, f"ep_groups_{'accum_' if steps > g_total else ''}fsdp2",
                         r["per_rank"], steps, run_kw["n_layers"], remat=False)
    fault_gap = _loss_gap(fault["losses"], ones["groups"]["losses"])
    _log(f"ep (b) groups (iv): each rank grouping its own tokens, losses "
         f"{[round(x, 5) for x in fault['losses']]}, {fault_gap:.3e} from one process's (limit "
         f"{GROUPS_LOSS_ATOL:.0e})")
    if fault_gap <= GROUPS_LOSS_ATOL:
        _fail(f"ep (b) groups (iv): the planted rank grouping reads {fault_gap:.3e}, within the limit")
    _sp_tp_part(kernels)
    return None


def _sp_tp_part(kernels):
    """Phase 14(c): 0.3b at sp=2,tp=4 with ulysses over the global kv heads
    (eight ranks sharing the card) against one process with flash, and the
    planted fault that keeps the output's heads at the sp coordinate."""
    import torch

    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import llama_train

    t0 = time.perf_counter()
    total = SP_TP_RUN["warmup"] + SP_TP_RUN["steps"]
    n_layers = SP_TP_RUN["n_layers"]
    spec = ",".join(f"{a}={n}" for a, n in SP_TP_MESH.items())
    torch.cuda.empty_cache()
    fa.reset_launch_count()
    one = llama_train.run(device="cuda", log=_log, attn_impl="flash", **SP_TP_RUN)
    _record_launches(kernels, "sp_tp_one_process", fa.launch_counts())
    torch.cuda.empty_cache()
    world = dict(SP_TP_RUN, mesh_spec=spec, attn_impl="ulysses")
    outs = _rank_world("runs", f"(c) {spec} ulysses", n=8, runs=[
        dict(world, digest=True), dict(world, plant="ulysses_sp_heads"),
    ])
    sound, fault = (outs[0]["runs"][i]["result"] for i in range(2))
    gap, fault_gap = _loss_gap(sound["losses"], one["losses"]), _loss_gap(fault["losses"], one["losses"])
    per = sound["per_rank"]
    _log(
        f"sp (c) {spec} ulysses: step {sound['step_s']:.4f} s, losses "
        f"{[round(x, 5) for x in sound['losses']]}; per rank (sp, tp) "
        f"{[(q['sp_index'], q['tp_index']) for q in per]}, param bytes {[q['param_bytes'] for q in per]}, "
        f"tp gathers {[q['tp_head_gathers'] for q in per]}, peak memory GiB "
        f"{[round((q['peak_mem_bytes'] or 0) / 2**30, 2) for q in per]}"
    )
    _, want_bytes = _tp_bytes("0.3b", "float32", SP_TP_MESH["tp"], n_layers=n_layers)
    # q, k and v gathered over tp once a layer a step (no remat).
    want_gathers = 3 * n_layers * total
    digests = {o["runs"][0]["params"] for o in outs}
    _log(
        f"sp (c): one process (flash) {[round(x, 5) for x in one['losses']]}, step {one['step_s']:.4f} s, "
        f"peak {(one['peak_mem_bytes'] or 0) / 2**30:.2f} GiB; {spec} ulysses within {gap:.3e} (limit "
        f"{SP_LOSS_ATOL:.0e}); planted sp-coordinate heads {fault_gap:.3e} "
        f"({[round(x, 5) for x in fault['losses']]}), step {fault['step_s']:.4f} s; param bytes a rank "
        f"want {want_bytes}, tp gathers a rank want {want_gathers}; parameter digests {sorted(digests)}; "
        f"{time.perf_counter() - t0:.1f} s"
    )
    if gap > SP_LOSS_ATOL or fault_gap <= SP_LOSS_ATOL:
        _fail(f"sp (c): losses {gap:.3e} from one process's, the planted fault {fault_gap:.3e} "
              f"(limit {SP_LOSS_ATOL:.0e})")
    if len(digests) != 1:
        _fail(f"sp (c): the sp ranks' parameters differ after the last step: {digests}")
    if (sound["world"], sound["backend"], sound["mesh"], len(sound["losses"])) != (8, "gloo", SP_TP_MESH, total):
        _fail("sp (c): world, backend, mesh or step count wrong")
    if [(q["sp_index"], q["tp_index"]) for q in per] != [(i, t) for i in range(2) for t in range(4)]:
        _fail(f"sp (c): rank coordinates {per}")
    if any(q["param_bytes"] != want_bytes for q in per):
        _fail(f"sp (c): a rank's parameter bytes are not its tp blocks and the norms ({want_bytes})")
    if any(q["tp_head_gathers"] != want_gathers for q in per):
        _fail(f"sp (c): tp gathers a rank {[q['tp_head_gathers'] for q in per]}, want {want_gathers}")
    if any(any(q["flash_launches"].values()) for q in per):
        _fail("sp (c): a flash kernel launched on the ulysses path")
    _record_launches(kernels, "sp_tp_ulysses", {k: 0 for k in fa.launch_counts()})


# Phase 15: pipeline parallelism.
PP_RUN = dict(config="0.3b", n_layers=8, batch_size=8, seq_len=2048, warmup=1, steps=2)
# The pp runs' losses against one process's over every step, in nats (the
# largest absolute difference), and the planted fault's above it.
# Predictions (PERF.md §6): 1e-4 to 2e-3 (the stages' gradients are sums of
# microbatch gradients in f32, one process's one backward's; the loss tail
# sums its chunks' partial statistics over pp); the fault 1e-2 to 0.3 (the
# CPU's tiny f32: 2.0e-2 to 7.6e-2).
PP_LOSS_ATOL = 5e-3


# (e) pp beside tp: 15(a)'s model, seed and rows at pp=2,tp=2 over four
# ranks, 1F1B at 4 microbatches, 1 + 2 steps (a rank attends 4 of the 8
# heads of a microbatch: PPTP_SHAPE); (f) pp beside ep: the MoE Llama at
# 0.3b width with phase 10's experts (8, top 2, capacity 1.25), aux weight
# 0 (JAX refuses it on a pp mesh), sparse dispatch, 4 layers, pp=2,ep=2
# (ep splits no batch: a rank attends at PP_SHAPE). A microbatch's 4,096
# tokens are four of the sparse layer's 1,024-token groups, the same four
# as one process's, so (f) holds against its own one process at
# EP_LOSS_ATOL. Both in one world of four ranks sharing the card.
PP_TP_RUN = dict(PP_RUN, mesh_spec="pp=2,tp=2", pp_schedule="1f1b")
PP_EP_RUN = dict(config="0.3b", n_layers=4, batch_size=8, seq_len=2048, warmup=1, steps=2,
                 n_experts=8, moe_top_k=2, moe_capacity_factor=1.25, moe_dispatch="sparse")
# (g) sparse dispatch in pp microbatches over data ranks: the MoE Llama at
# 0.3b width and 4 layers, capacity 0.5 (about half the routings drop, which
# ones set by the group's global order), aux weight 0, global B8 x 512 at
# dp=2,pp=2, 1F1B at 4 microbatches of the reference's rows: a microbatch's
# B2 x 512 is one 1,024-token group whose rows lie one on each data rank,
# so the top-k gather crosses ranks (at S 2,048, as in (f), a group lies
# inside one row). Held against one process accumulating over the same 4
# microbatches (the same groups, the same drops) to (f)'s EP_LOSS_ATOL, not
# to 14(b)'s GROUPS_LOSS_ATOL: at aux weight 0 and 4,096 tokens a step the
# sound run read 4.907e-04 and the planted old feed (each data coordinate's
# own rows split into the microbatches) 1.918e-02 on an H100 80GB HBM3 at
# 700 W, so 5e-2 would not tell them apart; the limit sits a factor 10 and
# 3.8 from them.
PP_GROUPS_RUN = dict(config="0.3b", n_layers=4, batch_size=8, seq_len=512, warmup=1, steps=2,
                     n_experts=8, moe_top_k=2, moe_capacity_factor=0.5, moe_dispatch="sparse",
                     moe_aux_weight=0.0)
PP_GROUPS_M = 4


# Phase 15(a)-(d)'s runs join the world of two ranks that phases 13 and 14
# share (_two_rank_world): their outputs and (d)'s checkpoint directory, for
# phase_pp.
_PP_WORLD = {}


def _pp_world_runs(ck) -> list:
    """Phase 15(a)-(d)'s runs in a world of two ranks: GPipe, 1F1B saving
    (d)'s checkpoint into ``ck``, and the planted fault."""
    return [
        dict(PP_RUN, mesh_spec="pp=2", pp_schedule="gpipe"),
        dict(PP_RUN, mesh_spec="pp=2", pp_schedule="1f1b", digest=True, checkpoint_every=1000,
             env={"TPUJOB_CHECKPOINT_DIR": str(ck)}),
        dict(PP_RUN, mesh_spec="pp=2", pp_schedule="1f1b", plant="pp_shifted_cotangent"),
    ]


def _pp_bytes(n_layers: int) -> list:
    """Each pp=2 rank's parameter bytes (f32) of 0.3b at ``n_layers``: its
    layers, the final norm and half the head; rank 0 the embedding too."""
    from pytorch_operator_tpu_torch.models import llama as llama_lib

    model = llama_lib.Llama(llama_lib.llama_0_3b(n_layers=n_layers), device="meta")
    sizes = {n: 4 * p.numel() for n, p in model.named_parameters()}
    stage = sum(v for n, v in sizes.items() if n.startswith("layers.")) // 2
    tail = sizes["final_norm.weight"] + sizes["lm_head.weight"] // 2
    return [sizes["embed.weight"] + stage + tail, stage + tail]


def _pp_tp_bytes(n_layers: int) -> list:
    """Each pp=2,tp=2 rank's parameter bytes (f32) of 0.3b at ``n_layers``,
    in rank order (pp outer, tp inner): its stage's layers as tp blocks
    (the norms whole), the final norm and a quarter of the head's rows;
    stage 0 half the embedding too."""
    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.parallel.sharding import tp_dim

    model = llama_lib.Llama(llama_lib.llama_0_3b(n_layers=n_layers), device="meta")
    stages = [0, 0]
    for name, p in model.named_parameters():
        b = 4 * p.numel() // (2 if tp_dim(name) is not None else 1)
        if name.startswith("layers."):
            stages[2 * int(name.split(".")[1]) // n_layers] += b
        elif name == "embed.weight":
            stages[0] += b
        else:  # the final norm and the head, on both stages
            stages = [x + (b // 2 if name == "lm_head.weight" else b) for x in stages]
    return [stages[0]] * 2 + [stages[1]] * 2


def _pp_launches(kernels, path: str, r: dict, microbatches: int, run=PP_RUN) -> None:
    """Each rank launched each kernel once a layer of its stage a
    microbatch a step; the ranks' sum into the kernels line."""
    total = run["warmup"] + run["steps"]
    per = run["n_layers"] // 2 * microbatches * total
    want = {"flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per}
    for q in r["per_rank"]:
        if q["flash_launches"] != want:
            _fail(f"pp {path}: rank {q['rank']} launched {q['flash_launches']}, expected {want}")
    _record_launches(kernels, path, {k: len(r["per_rank"]) * v for k, v in want.items()})


def _pp_describe(tag: str, r: dict) -> None:
    per = r["per_rank"]
    _log(
        f"pp {tag}: mesh {r['mesh']}, {r['pp_schedule']} over {r['pp_microbatches']} microbatches, "
        f"{r['value'] * r['world']:.1f} tokens/s over {r['world']} ranks sharing one card, step "
        f"{r['step_s']:.4f} s, losses {[round(x, 5) for x in r['losses']]}; per rank (data, pp, tp, ep) "
        f"{[(q['data_index'], q['pp_index'], q['tp_index'], q['ep_index']) for q in per]}, param bytes "
        f"{[q['param_bytes'] for q in per]}, expert bytes {[q['expert_param_bytes'] for q in per]}, "
        f"optimizer bytes {[q['optimizer_state_bytes'] for q in per]}, peak memory GiB "
        f"{[round((q['peak_mem_bytes'] or 0) / 2**30, 3) for q in per]}"
    )


def phase_pp(kernels):
    """Phase 15: (a) 0.3b at 8 layers, pp=2 with GPipe and 1F1B at 4
    microbatches against one process, their peaks; (b), the B16 runs at 8
    microbatches, given up for the time limit; (c) the planted
    shifted-cotangent fault; (d) the pp=2 checkpoint restored by one
    process; (e)-(g) pp beside tp and ep, and sparse dispatch in pp
    microbatches over data ranks (:func:`_pp_beside`). The kernels at the
    microbatch's shape (``PP_SHAPE``), at a pp=2,tp=2 rank's
    (``PPTP_SHAPE``) and at (g)'s reference microbatch (``GROUPS_SHAPE``)
    are held and timed in phases 2-3."""
    import shutil
    from pathlib import Path

    import torch

    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager
    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import llama_train

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fa.reset_launch_count()
    one = llama_train.run(device="cuda", log=_log, **PP_RUN)
    _record_launches(kernels, "pp_one_process", fa.launch_counts())
    torch.cuda.empty_cache()
    td, outs = _PP_WORLD.pop("dir"), _PP_WORLD.pop("outs")  # phase 13's world ran them
    try:
        ck = Path(td) / "ck"
        t_restore = time.perf_counter()
        step, params = CheckpointManager(ck, create=False).restore_subtree("params")
        order = llama_lib.Llama(llama_lib.llama_0_3b(n_layers=PP_RUN["n_layers"]), device="meta").state_dict()
        restored = _params_digest((name, params[name]) for name in order)
        del params
        t_restore = time.perf_counter() - t_restore
    finally:
        shutil.rmtree(td, ignore_errors=True)
    runs = [r["result"] for r in outs[0]["runs"]]
    gpipe, f1b, fault = runs
    total = PP_RUN["warmup"] + PP_RUN["steps"]

    # (a) GPipe and 1F1B at 4 microbatches against one process.
    want_bytes = _pp_bytes(PP_RUN["n_layers"])
    _log(f"pp (a): one process {[round(x, 5) for x in one['losses']]}, step {one['step_s']:.4f} s, "
         f"param bytes {one['param_bytes']}, peak {(one['peak_mem_bytes'] or 0) / 2**30:.3f} GiB; "
         f"param bytes a rank want {want_bytes}")
    for tag, r in (("gpipe", gpipe), ("1f1b", f1b)):
        _pp_describe(f"(a) pp=2 {tag}", r)
        _pp_launches(kernels, f"pp_{tag}_m4", r, 4)
        gap = _loss_gap(r["losses"], one["losses"])
        _log(f"pp (a) {tag}: losses within {gap:.3e} of one process's (limit {PP_LOSS_ATOL:.0e})")
        if gap > PP_LOSS_ATOL or len(r["losses"]) != total:
            _fail(f"pp (a) {tag}: losses {gap:.3e} from one process's")
        if (r["world"], r["backend"], r["mesh"], r["pp_schedule"], r["pp_microbatches"]) != (
            2, "gloo", {"pp": 2}, tag, 4
        ):
            _fail(f"pp (a) {tag}: world, backend, mesh or schedule wrong")
        if [(q["data_index"], q["pp_index"]) for q in r["per_rank"]] != [(0, 0), (0, 1)]:
            _fail(f"pp (a) {tag}: rank coordinates {r['per_rank']}")
        if [q["param_bytes"] for q in r["per_rank"]] != want_bytes:
            _fail(f"pp (a) {tag}: per-rank parameter bytes {[q['param_bytes'] for q in r['per_rank']]}")

    # (b), the B16 runs at 8 microbatches, is given up for the time limit
    # (PERF.md §7): tests/test_torch_pipeline.py holds GPipe's residency and
    # 1F1B's ring on the CPU.
    peaks = {tag: [q["peak_mem_bytes"] or 0 for q in r["per_rank"]] for tag, r in (("gpipe", gpipe), ("1f1b", f1b))}
    _log(f"pp (a): peak GiB a rank {({k: [round(x / 2**30, 3) for x in v] for k, v in peaks.items()})}")

    # (c) the planted fault, then (d) the checkpoint.
    fault_gap = _loss_gap(fault["losses"], one["losses"])
    _log(f"pp (c): planted shifted-cotangent fault {fault_gap:.3e} from one process's "
         f"({[round(x, 5) for x in fault['losses']]}; limit {PP_LOSS_ATOL:.0e})")
    if fault_gap <= PP_LOSS_ATOL:
        _fail(f"pp (c): the planted fault's losses are within {fault_gap:.3e} of one process's")
    digests = {o["runs"][1]["params"] for o in outs}
    _log(f"pp (d): step {step} restored by one process in {t_restore:.1f} s, digest {restored}; the "
         f"ranks' gathered parameters {sorted(digests)}; {time.perf_counter() - t0:.1f} s")
    if step != total or digests != {restored}:
        _fail("pp (d): the one-process restore differs from the ranks' gathered parameters")
    _pp_beside(kernels, one)
    _log(f"pp: phase {time.perf_counter() - t0:.1f} s")
    return None


def _pp_beside(kernels, one: dict) -> None:
    """Phase 15(e)-(g): pp beside tp (against (a)'s one process, the
    planted tp-outer head rows), beside ep (against its own one process)
    and sparse dispatch in pp microbatches over data ranks (against one
    process accumulating over the same microbatches, the planted old
    feed), in one world of four ranks."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import llama_train

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    fa.reset_launch_count()
    one_ep = llama_train.run(device="cuda", log=_log, **PP_EP_RUN)
    _record_launches(kernels, "pp_ep_one_process", fa.launch_counts())
    torch.cuda.empty_cache()
    fa.reset_launch_count()
    one_groups = llama_train.run(device="cuda", log=_log, grad_accum=PP_GROUPS_M, **PP_GROUPS_RUN)
    _record_launches(kernels, "pp_groups_one_process_accum4", fa.launch_counts())
    torch.cuda.empty_cache()
    ep_world = dict(PP_EP_RUN, mesh_spec="pp=2,ep=2", pp_schedule="1f1b")
    groups_world = dict(PP_GROUPS_RUN, mesh_spec="dp=2,pp=2", pp_schedule="1f1b",
                        pp_microbatches=PP_GROUPS_M)
    td = tempfile.mkdtemp(prefix="chip_smoke_pp_tp_")
    try:
        ck_tp = Path(td) / "ck_tp"
        # Phase 13(c)'s run first, with the world's one checkpoint.
        outs = _rank_world(
            "runs", "13(c) fsdp=2,tp=2 and 15(e)-(g) pp=2,tp=2, pp=2,ep=2 and dp=2,pp=2", n=4, runs=[
                dict(TP_FOUR_RUN, mesh_spec="fsdp=2,tp=2", digest=True, checkpoint_every=1000,
                     env={"TPUJOB_CHECKPOINT_DIR": str(ck_tp)}),
                PP_TP_RUN,
                # The fault shows from the first step.
                dict(PP_TP_RUN, steps=1, plant="pp_tp_outer_head"),
                ep_world,
                groups_world,
                dict(groups_world, plant="pp_coordinate_rows"),
            ])
        _tp_four_checks(kernels, outs, ck_tp)
    finally:
        shutil.rmtree(td, ignore_errors=True)
    tp_run, fault, ep_run, groups_run, groups_fault = (r["result"] for r in outs[0]["runs"][1:])
    _log(f"pp (e)-(g): the world's runs took {[round(r['wall_s'], 1) for r in outs[0]['runs']]} s on rank 0")

    # (e) pp=2,tp=2 against (a)'s one process at the same steps.
    total = PP_TP_RUN["warmup"] + PP_TP_RUN["steps"]
    want_bytes = _pp_tp_bytes(PP_TP_RUN["n_layers"])
    _pp_describe("(e) pp=2,tp=2", tp_run)
    _pp_launches(kernels, "pp_tp_1f1b_m4", tp_run, 4, PP_TP_RUN)
    gap = _loss_gap(tp_run["losses"], one["losses"])
    fault_gap = _loss_gap(fault["losses"], one["losses"])
    _log(f"pp (e): losses within {gap:.3e} of (a)'s one process (limit {PP_LOSS_ATOL:.0e}); param "
         f"bytes a rank want {want_bytes}; planted tp-outer head rows {fault_gap:.3e} "
         f"({[round(x, 5) for x in fault['losses']]}), step {fault['step_s']:.4f} s")
    if gap > PP_LOSS_ATOL or len(tp_run["losses"]) != total:
        _fail(f"pp (e): losses {gap:.3e} from one process's")
    if fault_gap <= PP_LOSS_ATOL:
        _fail(f"pp (e): the planted head nesting fault's losses are within {fault_gap:.3e} of one process's")
    if (tp_run["world"], tp_run["mesh"]) != (4, {"pp": 2, "tp": 2}) or [
            (q["pp_index"], q["tp_index"]) for q in tp_run["per_rank"]] != [(0, 0), (0, 1), (1, 0), (1, 1)]:
        _fail(f"pp (e): world, mesh or rank coordinates wrong: {tp_run['mesh']}")
    if [q["param_bytes"] for q in tp_run["per_rank"]] != want_bytes:
        _fail(f"pp (e): per-rank parameter bytes {[q['param_bytes'] for q in tp_run['per_rank']]}")

    # (f) pp=2,ep=2 against its own one process.
    experts = sum(4 * p.numel() for n, p in llama_lib.Llama(
        llama_lib.llama_0_3b(n_layers=PP_EP_RUN["n_layers"], n_experts=8), device="meta").named_parameters()
        if n.endswith(("moe_mlp.w_in", "moe_mlp.w_out")))
    _pp_describe("(f) pp=2,ep=2", ep_run)
    _pp_launches(kernels, "pp_ep_1f1b_m4", ep_run, 4, PP_EP_RUN)
    gap = _loss_gap(ep_run["losses"], one_ep["losses"])
    _log(f"pp (f): one process {[round(x, 5) for x in one_ep['losses']]}, step {one_ep['step_s']:.4f} s, "
         f"peak {(one_ep['peak_mem_bytes'] or 0) / 2**30:.3f} GiB; pp=2,ep=2 within {gap:.3e} (limit "
         f"{EP_LOSS_ATOL:.0e}); expert bytes a rank want {experts // 4}; {time.perf_counter() - t0:.1f} s")
    if gap > EP_LOSS_ATOL or len(ep_run["losses"]) != len(one_ep["losses"]):
        _fail(f"pp (f): losses {gap:.3e} from one process's")
    if [(q["pp_index"], q["ep_index"]) for q in ep_run["per_rank"]] != [(0, 0), (0, 1), (1, 0), (1, 1)]:
        _fail(f"pp (f): rank coordinates {ep_run['per_rank']}")
    if [q["expert_param_bytes"] for q in ep_run["per_rank"]] != [experts // 4] * 4:
        _fail(f"pp (f): expert bytes {[q['expert_param_bytes'] for q in ep_run['per_rank']]}")
    _pp_groups_checks(kernels, one_groups, groups_run, groups_fault)
    _log(f"pp (e)-(g): {time.perf_counter() - t0:.1f} s")


def _pp_groups_checks(kernels, one: dict, r: dict, fault: dict) -> None:
    """Phase 15(g)'s checks: dp=2,pp=2 sparse against one process
    accumulating over the same 4 microbatches, every step's loss within
    ``EP_LOSS_ATOL`` and the planted old feed above it; the ranks'
    coordinates (pp outer, data inner), each rank's expert bytes (E of its
    stage's layers: dp replicates them) and its launches (each kernel once
    a layer of its stage a microbatch, at a rank's B1 S512)."""
    from pytorch_operator_tpu_torch.models import llama as llama_lib

    experts = sum(4 * p.numel() for n, p in llama_lib.Llama(
        llama_lib.llama_0_3b(n_layers=PP_GROUPS_RUN["n_layers"], n_experts=8), device="meta").named_parameters()
        if n.endswith(("moe_mlp.w_in", "moe_mlp.w_out")))
    _pp_describe("(g) dp=2,pp=2 sparse", r)
    _pp_launches(kernels, "pp_groups_dp2_1f1b_m4", r, PP_GROUPS_M, PP_GROUPS_RUN)
    gap = _loss_gap(r["losses"], one["losses"])
    fault_gap = _loss_gap(fault["losses"], one["losses"])
    _log(f"pp (g): one process accumulating over {PP_GROUPS_M} microbatches "
         f"{[round(x, 5) for x in one['losses']]}, step {one['step_s']:.4f} s, peak "
         f"{(one['peak_mem_bytes'] or 0) / 2**30:.3f} GiB; dp=2,pp=2 within {gap:.3e} (limit "
         f"{EP_LOSS_ATOL:.0e}); planted coordinate-row feed {fault_gap:.3e} "
         f"({[round(x, 5) for x in fault['losses']]}), step {fault['step_s']:.4f} s; expert bytes a "
         f"rank want {experts // 2}")
    if gap > EP_LOSS_ATOL or len(r["losses"]) != len(one["losses"]):
        _fail(f"pp (g): losses {gap:.3e} from one process's")
    if fault_gap <= EP_LOSS_ATOL:
        _fail(f"pp (g): the planted coordinate-row feed's losses are within {fault_gap:.3e} of one process's")
    if (r["world"], r["mesh"], r["pp_schedule"], r["pp_microbatches"]) != (
            4, {"pp": 2, "dp": 2}, "1f1b", PP_GROUPS_M):
        _fail(f"pp (g): world, mesh or schedule wrong: {r['mesh']}")
    if [(q["pp_index"], q["data_index"]) for q in r["per_rank"]] != [(0, 0), (0, 1), (1, 0), (1, 1)]:
        _fail(f"pp (g): rank coordinates {r['per_rank']}")
    if [q["expert_param_bytes"] for q in r["per_rank"]] != [experts // 2] * 4:
        _fail(f"pp (g): expert bytes {[q['expert_param_bytes'] for q in r['per_rank']]}")


# Phase 16: the digit CNN through mnist_train (examples/mnist.yaml; BASELINE.json's
# first config is its two-rank form) and BERT-base through bert_fsdp
# (BASELINE.json's third). Neither path runs a flash kernel, as in JAX.
MNIST_ARGS = ["--epochs", "8"]  # examples/mnist.yaml: 88 steps of B128 over 1,438 images
MNIST_TARGET = 0.97  # mnist_train's --target-acc default, JAX's bar
# (d): two ranks, 2 epochs (22 steps), each exits 0 at this target.
MNIST_WORLD_ARGS = ["--epochs", "2", "--target-acc", "0.8"]
# (a) the digit CNN in f32 on the card against the CPU (TF32 off), the
# relative L2 error of the logits and of the worst gradient; the planted
# (c, h, w) flatten above it. Predictions (PERF.md §6): 1e-7 to 1e-5; the
# fault 0.3 to 1.5.
MNIST_CARD_CPU_RTOL = 1e-4
# (d) and (f): every step's loss against one process's, the largest absolute
# difference in nats.
WORLD16_LOSS_ATOL = 5e-3
# (e) bench.py:592-600's recipe: BERT-base, B64 x S128, 3 warmup + 30 steps,
# AdamW at a constant lr 1e-4. It does not learn the two-topic set in its 33
# steps (on the H100: final accuracy 0.5156, the loss 3.04 after the first
# update; the port follows JAX's losses at full width and 2 layers on the
# CPU), so the learning check runs the same with a 10-step warmup and
# cosine decay (bert_fsdp --lr-warmup-steps 10: final accuracy 1.0; PERF.md
# §6).
BERT_RUN = dict(bert_base=True, batch_size=64, seq_len=128, steps=30, warmup=3)
BERT_LEARN = dict(BERT_RUN, lr_warmup_steps=10)
BERT_ACC_MIN = 0.9  # the JAX test's bar (tests/test_workloads_lm.py:41-47)
BERT_PARAMS_M = 109.5
# (e) BERT-base in f32 on the card against the CPU, B2 x S128 with a pad mask
# (row 1: 77 real tokens): the relative L2 error of the sequence output and
# of the logits; the planted fault (the mask dropped) above it. Predictions
# (PERF.md §6): 1e-7 to 1e-5; the fault 1e-2 to 1.
BERT_CARD_CPU_RTOL = 1e-4
# (f) one world of two ranks sharing the card, three meshes: fsdp=2, the
# global B64 x S128, 1 + 3 steps, each rank's parameter and AdamW bytes
# within this share of half of (e)'s; BERT-base at tp=2, the same recipe;
# sp=2 (replicas, every gradient averaged over sp after the backward), 1 + 1
# steps. Each run's losses against (e)'s within WORLD16_LOSS_ATOL.
BERT_WORLD_RUN = dict(BERT_RUN, steps=3, warmup=1, mesh_spec="fsdp=2")
BERT_HALF_RTOL = 0.01
BERT_TP_RUN = dict(BERT_WORLD_RUN, mesh_spec="tp=2")
BERT_SP_RUN = dict(BERT_WORLD_RUN, steps=1, mesh_spec="sp=2")
# A tp=2 rank's parameter bytes, exactly (f32): half of the tensors tp
# splits (q, k, v and mlp_up with their biases, o_proj, mlp_down, the word
# embedding: 108,440,064 elements) and the whole rest (pos_embed, the
# LayerNorms, the pooler, the classifier, the row-parallel biases:
# 1,042,178), against one process's 437,928,968.
BERT_TP_BYTES = 4 * (108_440_064 // 2 + 1_042_178)
# (f) at tp=2 on the same ranks: the tp model at full width in f32 (TF32
# off) against the whole model on the same rank, B2 x S128 with a pad mask
# (row 1: 77 real tokens), every bias drawn N(0, BERT_TP_BIAS_STD) so that a
# doubled one shows; the relative L2 error of the sequence output and of the
# logits, and the planted fault (the row-parallel bias added on both ranks)
# above it. Predictions (PERF.md §6): 1e-7 to 1e-5; the fault 1e-3 to 1e-1.
BERT_TP_BIAS_STD = 0.02
BERT_TP_RTOL = 1e-4


def _chw_flatten_forward(model, x):
    """The digit CNN with its pooled map flattened in (c, h, w) order: the
    planted fault of (a)."""
    import torch.nn.functional as F

    dt = model.dtype
    x = x.to(dt).permute(0, 3, 1, 2)
    x = F.relu(F.conv2d(x, model.Conv_0.weight.to(dt), model.Conv_0.bias.to(dt), padding=1))
    x = F.relu(F.conv2d(x, model.Conv_1.weight.to(dt), model.Conv_1.bias.to(dt), padding=1))
    x = F.max_pool2d(x, 2, 2).reshape(x.shape[0], -1)
    x = F.relu(F.linear(x, model.Dense_0.weight.to(dt), model.Dense_0.bias.to(dt)))
    return F.linear(x.float(), model.Dense_1.weight, model.Dense_1.bias)


def _card_vs_cpu(build, inputs, outputs, forwards) -> dict:
    """``outputs(model, forward, *inputs)`` → ``(tensors, loss)`` on the CPU
    and then on the card for each ``forwards`` entry (name: what ``outputs``
    reads as the forward to run, None for the model's own) from one model's
    weights, TF32 off; each card run's largest relative L2 error against the
    CPU over the tensors, and over the parameters' gradients."""
    import copy

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build()

    def run(dev, forward):
        m = copy.deepcopy(model).to(dev)
        tensors, loss = outputs(m, forward, *(t.to(dev) for t in inputs))
        loss.backward()
        return [t.detach().float().cpu() for t in tensors], {
            n: p.grad.detach().float().cpu() for n, p in m.named_parameters() if p.grad is not None}

    ref = run("cpu", None)
    # A gradient that is zero in exact arithmetic (BERT's key biases: the
    # softmax is invariant to a shift of a query's scores) is held against a
    # tenth of the mean gradient norm.
    norms = {n: torch.linalg.vector_norm(g).item() for n, g in ref[1].items()}
    floor = 0.1 * sum(norms.values()) / len(norms)
    gaps = {}
    for name, forward in forwards.items():
        got = run("cuda", forward)
        gaps[name] = {
            "outputs": max(_rel_l2(a, b) for a, b in zip(got[0], ref[0])),
            "grads": max(torch.linalg.vector_norm(got[1][n] - g).item() / max(norms[n], floor)
                         for n, g in ref[1].items()),
        }
    return gaps


def _mnist_main(argv) -> tuple:
    """``mnist_train.main(argv + ["--json"])`` in this process: its exit
    code and its result line (stdout captured, then logged)."""
    import contextlib
    import io

    from pytorch_operator_tpu_torch.workloads import mnist_train

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = mnist_train.main(list(argv) + ["--json"])
    lines = buf.getvalue().strip().splitlines()
    for line in lines[:-1]:
        _log(f"mnist {line}")
    return code, json.loads(lines[-1]), time.perf_counter() - t0


def _mnist_describe(tag: str, code: int, r: dict, wall: float) -> None:
    _log(f"mnist {tag}: exit {code}, test accuracy {r['test_accuracy']:.4f}, {r['steps']} steps of "
         f"B{r['global_batch']}, run() -> first step {r['first_step_s']:.2f} s, "
         f"{r['images_per_sec']:.1f} images/sec after it, losses {r['losses'][0]:.4f} -> "
         f"{r['losses'][-1]:.4f}, {wall:.1f} s in all")


def _mnist_parts(kernels):
    """(a) card vs CPU with the planted flatten; (b) main as
    examples/mnist.yaml; (c) the packed file inline and prefetched; (d) two
    ranks. Returns (b)'s result, the one-process reference of (d)."""
    import shutil
    import tempfile

    import torch
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.data import pack
    from pytorch_operator_tpu_torch.models.mnist import DigitCNN
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads.datasets import digits

    # (a)
    x, y = digits("train")
    inputs = (torch.from_numpy(x[:128]), torch.from_numpy(y[:128]).long())

    def outputs(m, forward, bx, by):
        logits = m(bx) if forward is None else forward(m, bx)
        return [logits], F.cross_entropy(logits, by)

    gaps = _card_vs_cpu(lambda: DigitCNN(dtype=torch.float32, seed=0), inputs, outputs,
                        {"sound": None, "fault": _chw_flatten_forward})
    _log(f"mnist (a) DigitCNN f32 B128, card vs CPU: logits {gaps['sound']['outputs']:.3e}, worst gradient "
         f"{gaps['sound']['grads']:.3e}; planted (c, h, w) flatten {gaps['fault']['outputs']:.3e} / "
         f"{gaps['fault']['grads']:.3e} (limit {MNIST_CARD_CPU_RTOL:.0e}, relative L2)")
    if max(gaps["sound"].values()) > MNIST_CARD_CPU_RTOL:
        _fail(f"mnist (a): the card disagrees with the CPU ({gaps['sound']})")
    if gaps["fault"]["outputs"] <= MNIST_CARD_CPU_RTOL:
        _fail("mnist (a): the planted (c, h, w) flatten reads within the limit")

    # (b)
    fa.reset_launch_count()
    code, one, wall = _mnist_main(MNIST_ARGS)
    _record_launches(kernels, "mnist_main", fa.launch_counts())
    _mnist_describe("(b) main --epochs 8", code, one, wall)
    if code != 0 or one["test_accuracy"] < MNIST_TARGET or one["steps"] != 88:
        _fail(f"mnist (b): exit {code}, accuracy {one['test_accuracy']}, {one['steps']} steps")

    # (c)
    td = tempfile.mkdtemp(prefix="chip_smoke_mnist_")
    deterministic = torch.backends.cudnn.deterministic
    try:
        f = f"{td}/digits.bin"
        pack.main(["--dataset", "digits", "--out", f])
        torch.backends.cudnn.deterministic = True
        fa.reset_launch_count()
        runs = {p: _mnist_main(MNIST_ARGS + ["--data-file", f, "--prefetch", str(p)]) for p in (0, 2)}
        _record_launches(kernels, "mnist_file", fa.launch_counts())
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(td, ignore_errors=True)
    for p, (code, r, wall) in runs.items():
        _mnist_describe(f"(c) --data-file, --prefetch {p}", code, r, wall)
        if code != 0 or r["steps"] != 88:
            _fail(f"mnist (c): --prefetch {p} exited {code} after {r['steps']} steps")
    if runs[0][1]["losses"] != runs[2][1]["losses"]:
        _fail("mnist (c): the prefetched run's losses differ from the inline run's")

    # (d)
    t0 = time.perf_counter()
    outs = _run_world([sys.executable, "-m", "pytorch_operator_tpu_torch.workloads.mnist_train",
                       *MNIST_WORLD_ARGS, "--json"], "(d) mnist dp=2")
    two = json.loads(outs[0][1].strip().splitlines()[-1])
    n = len(two["losses"])
    gap = _loss_gap(two["losses"], one["losses"][:n])
    _log(f"mnist (d) dp=2 on one card ({two['device']}): exit codes {[o[0] for o in outs]}, test accuracy "
         f"{two['test_accuracy']:.4f}, {two['steps']} steps, {two['images_per_sec']:.1f} images/sec over two "
         f"ranks; losses within {gap:.3e} of one process's first {n} (limit {WORLD16_LOSS_ATOL:.0e}); "
         f"{time.perf_counter() - t0:.1f} s")
    if (two["devices"], n) != (2, 22) or gap > WORLD16_LOSS_ATOL:
        _fail(f"mnist (d): {two['devices']} ranks, {n} steps, losses {gap:.3e} from one process's")


def _bert_card_vs_cpu():
    """(e) BERT-base in f32, B2 x S128 with a pad mask, card against CPU;
    the planted dropped mask."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.models import bert
    from pytorch_operator_tpu_torch.workloads.bert_fsdp import synthetic_topic_batch

    toks, labels = synthetic_topic_batch(2, 128, 30522, 0)
    pad = np.arange(128)[None, :] < np.array([128, 77])[:, None]
    inputs = (torch.from_numpy(toks).long(), torch.from_numpy(labels).long(), torch.from_numpy(pad))

    def outputs(m, forward, tokens, lbl, mask):
        seq, pooled = m.bert(tokens, None, None if forward == "no mask" else mask)
        logits = m.classifier(pooled)
        return [seq, logits], F.cross_entropy(logits, lbl)

    gaps = _card_vs_cpu(lambda: bert.BertClassifier(bert.bert_base(dtype=torch.float32), 2, seed=0),
                        inputs, outputs, {"sound": None, "fault": "no mask"})
    _log(f"bert (e) BERT-base f32 B2 x S128 (pad mask), card vs CPU: sequence output and logits "
         f"{gaps['sound']['outputs']:.3e}, worst gradient {gaps['sound']['grads']:.3e}; planted fault (the "
         f"mask dropped) {gaps['fault']['outputs']:.3e} / {gaps['fault']['grads']:.3e} (limit "
         f"{BERT_CARD_CPU_RTOL:.0e}, relative L2)")
    if max(gaps["sound"].values()) > BERT_CARD_CPU_RTOL:
        _fail(f"bert (e): the card disagrees with the CPU ({gaps['sound']})")
    if gaps["fault"]["outputs"] <= BERT_CARD_CPU_RTOL:
        _fail("bert (e): the planted dropped mask reads within the limit")


def _bert_tp_module(dev, config: str) -> dict:
    """(f) in a rank of a tp world: BERT-base (``config`` ``"base"``;
    ``"tiny"`` for a rehearsal on the CPU) in f32, every bias drawn N(0,
    ``BERT_TP_BIAS_STD``), the tp model's sequence output and logits on B2
    x S128 with a pad mask against the whole model's on this rank, by
    relative L2; sound and under the planted row-parallel bias fault."""
    import numpy as np
    import torch

    from pytorch_operator_tpu_torch.models import bert
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh
    from pytorch_operator_tpu_torch.parallel.sharding import model_splits, take_block
    from pytorch_operator_tpu_torch.workloads.bert_fsdp import synthetic_topic_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = getattr(bert, f"bert_{config}")(dtype=torch.float32)
    whole = bert.BertClassifier(cfg, 2, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in whole.named_parameters():
            if name.endswith("bias") and "_ln." not in name:
                p.normal_(0.0, BERT_TP_BIAS_STD, generator=gen)
    sd = whole.state_dict()
    mesh = make_mesh({"tp": torch.distributed.get_world_size()}, dev.type)
    model = bert.BertClassifier(cfg, 2, seed=0, mesh=mesh)
    model.load_state_dict({n: take_block(t, model_splits(model, n)) for n, t in sd.items()})
    whole.to(dev)
    model.to(dev)
    S = min(128, cfg.max_len)
    toks, _ = synthetic_topic_batch(2, S, cfg.vocab_size, 0)
    pad = np.arange(S)[None, :] < np.array([S, 77 * S // 128])[:, None]
    inputs = (torch.from_numpy(toks).long().to(dev), None, torch.from_numpy(pad).to(dev))

    def outputs(m):
        with torch.no_grad():
            seq, pooled = m.bert(*inputs)
            return seq, m.classifier(pooled)

    want = outputs(whole)
    gaps = {}
    for tag, plant in (("sound", None), ("fault", "bert_bias_every_rank")):
        with _planted(plant):
            got = outputs(model)
        gaps[tag] = {k: float((g - w).norm() / w.norm()) for k, g, w in zip(("seq", "logits"), got, want)}
    del whole, model
    torch.cuda.empty_cache()
    return gaps


def _bert_parts(kernels):
    """(e) bench.py's BERT-base recipe, the same with a warmup (learning),
    then card vs CPU; (f) fsdp=2, tp=2 and sp=2 on two ranks, and the tp
    module against the whole model with the planted row-parallel bias."""
    import torch

    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import bert_fsdp

    torch.cuda.empty_cache()
    fa.reset_launch_count()
    one = bert_fsdp.run(device="cuda", log=_log, **BERT_RUN)
    _record_launches(kernels, "bert_base", fa.launch_counts())
    tokens = BERT_RUN["batch_size"] * BERT_RUN["seq_len"]
    flops = tokens * (6.0 * one["params_m"] * 1e6 + 12.0 * one["n_layers"] * BERT_RUN["seq_len"] * one["d_model"])
    _log(f"bert (e) BERT-base B64 x S128: {one['value']} sequences/sec/chip, step {one['step_s'] * 1e3:.2f} ms "
         f"({flops / one['step_s'] / 1e12:.1f} TFLOP/s, {flops / one['step_s'] / PEAK_OPS['bfloat16']:.1%} of "
         f"the dense bf16 peak), peak memory {one['peak_mem_bytes'] / 2**30:.3f} GiB, params_m "
         f"{one['params_m']}, final accuracy {one['final_accuracy']}, losses "
         f"{[round(x, 4) for x in one['losses']]}")
    if one["params_m"] != BERT_PARAMS_M or not all(math.isfinite(x) for x in one["losses"]):
        _fail(f"bert (e): params_m {one['params_m']}, losses {one['losses']}")
    torch.cuda.empty_cache()
    learn = bert_fsdp.run(device="cuda", log=_log, **BERT_LEARN)
    _log(f"bert (e) with a {BERT_LEARN['lr_warmup_steps']}-step warmup: final accuracy {learn['final_accuracy']} (at least "
         f"{BERT_ACC_MIN}), accuracies {[round(a, 3) for a in learn['accuracies']]}, losses "
         f"{[round(x, 4) for x in learn['losses']]}, step {learn['step_s'] * 1e3:.2f} ms")
    if learn["final_accuracy"] < BERT_ACC_MIN:
        _fail(f"bert (e): final accuracy {learn['final_accuracy']} with a warmup")
    torch.cuda.empty_cache()
    _bert_card_vs_cpu()
    torch.cuda.empty_cache()
    _bert_world(kernels, one)


def _bert_world(kernels, one: dict) -> None:
    """(f) fsdp=2, tp=2 and sp=2 in one world of two ranks, each against
    (e)'s one process ``one``, then the tp module check on the same
    ranks."""
    t0 = time.perf_counter()
    outs = _rank_world("bert", "(f) BERT-base fsdp=2, tp=2, sp=2", runs=[
        BERT_WORLD_RUN, dict(BERT_TP_RUN, digest=True), dict(BERT_SP_RUN, digest=True),
    ], module="base")
    for i, (axis, run_kw) in enumerate((("fsdp", BERT_WORLD_RUN), ("tp", BERT_TP_RUN), ("sp", BERT_SP_RUN))):
        done = [o["runs"][i] for o in outs]
        runs = [d["result"] for d in done]
        n = run_kw["warmup"] + run_kw["steps"]
        mesh = {axis: 2}
        gap = max(_loss_gap(r["losses"], one["losses"][:n]) for r in runs)
        launches = {k: sum(d["flash_launches"][k] for d in done) for k in done[0]["flash_launches"]}
        _log(f"bert (f) {mesh} on one card ({runs[0]['backend']}): step {runs[0]['step_s']:.3f} s, losses "
             f"{[round(x, 5) for x in runs[0]['losses']]} within {gap:.3e} of one process's (limit "
             f"{WORLD16_LOSS_ATOL:.0e}); parameter bytes a rank {[r['param_bytes'] for r in runs]}, AdamW "
             f"bytes {[r['optimizer_state_bytes'] for r in runs]} (one process {one['param_bytes']} and "
             f"{one['optimizer_state_bytes']}), peak GiB {[round((r['peak_mem_bytes'] or 0) / 2**30, 3) for r in runs]}, "
             f"flash launches {launches}")
        if gap > WORLD16_LOSS_ATOL or any(len(r["losses"]) != n or r["mesh"] != mesh for r in runs):
            _fail(f"bert (f) {mesh}: losses {gap:.3e} from one process's, or the wrong mesh")
        if any(launches.values()):
            _fail(f"bert (f) {mesh}: a flash kernel launched on BERT's path ({launches})")
        _record_launches(kernels, f"bert_{axis}2", launches)
        if axis == "fsdp":
            for r in runs:
                for k in ("param_bytes", "optimizer_state_bytes"):
                    if abs(r[k] / (one[k] / 2) - 1) > BERT_HALF_RTOL:
                        _fail(f"bert (f): rank {k} {r[k]} is not about half of one process's {one[k]}")
            continue
        digests = {(d["digest"], d["whole_digest"]) for d in done}
        _log(f"bert (f) {mesh}: the ranks' gathered parameters {sorted(d['digest'] for d in done)}, the "
             f"tensors tp holds whole {sorted(d['whole_digest'] for d in done)}")
        if len(digests) != 1:
            _fail(f"bert (f) {mesh}: the ranks' parameters differ after the last step")
        want_bytes = BERT_TP_BYTES if axis == "tp" else one["param_bytes"]
        if any(r["param_bytes"] != want_bytes for r in runs):
            _fail(f"bert (f) {mesh}: parameter bytes a rank {[r['param_bytes'] for r in runs]}, want {want_bytes}")
    _log(f"bert (f): the world's runs took {[round(r['wall_s'], 1) for r in outs[0]['runs']]} s and the module "
         f"check {outs[0]['module_s']:.1f} s on rank 0")
    gaps = [o["module"] for o in outs]
    sound = max(max(g["sound"].values()) for g in gaps)
    fault = min(min(g["fault"].values()) for g in gaps)
    _log(f"bert (f) tp=2 module, f32, biases N(0, {BERT_TP_BIAS_STD}), against the whole model: sequence "
         f"output and logits {[g['sound'] for g in gaps]}; planted row-parallel bias on both ranks "
         f"{[g['fault'] for g in gaps]} (limit {BERT_TP_RTOL:.0e}, relative L2); {time.perf_counter() - t0:.1f} s")
    if sound > BERT_TP_RTOL or fault <= BERT_TP_RTOL:
        _fail(f"bert (f) tp=2 module: sound {sound:.3e}, the planted fault {fault:.3e} (limit {BERT_TP_RTOL:.0e})")


def phase_mnist_bert(kernels):
    """Phase 16: (a)-(d) the digit CNN through mnist_train, (e)-(f) BERT-base
    through bert_fsdp. Neither launches a flash kernel; their paths record
    0 launches."""
    t_phase = time.perf_counter()
    for part, run in (("(a)-(d)", _mnist_parts), ("(e)-(f)", _bert_parts)):
        t0 = time.perf_counter()
        run(kernels)
        _log(f"mnist/bert {part}: {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        for path in ("mnist_main", "mnist_file", "bert_base", "bert_fsdp2", "bert_tp2", "bert_sp2"):
            if k["launches_by_path"].get(path):
                _fail(f"phase 16: {path} launched {k['name']}, which its path does not run")
    _log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return None


# Phase 17: (a) an HF-layout state dict at Llama-3-8B's width (d_model
# 4096, 32/8 heads, head_dim 128, d_ff 14336, vocabulary 128256, rope theta
# 500000), cut to IMPORT_LAYERS of its 32 layers so that the f32 reference
# fits the time and memory budget; bf16 weights drawn on the card with HF's
# initializer range, the norm scales 1 + 0.1 N(0, 1).
IMPORT_LAYERS = 4
IMPORT_STD = 0.02
IMPORT_CHECK = (2, 128)  # B, S of the logits check
# Generate's batch and prompt length are IMPORT_PREFILL's, the shape at
# which phase 2 holds and times the forward kernel.
IMPORT_GEN = dict(batch=IMPORT_PREFILL[1], prompt_len=IMPORT_PREFILL[2], new_tokens=8)
# The port's Llama in f32 on the imported weights against the plain
# HF-convention forward in f32 on the same bf16 values (TF32 off): the
# largest absolute logit difference (logits ~1.3 std). Predictions
# (PERF.md §6): 1e-6 to 1e-4; a planted mapping fault (layers 0 and 1's
# q_proj swapped) 1e-1 or more.
IMPORT_LOGITS_ATOL = 1e-3
# (b) phase 5's training step counted on meta tensors.
FLOP_COUNT_SHAPE = (4, 4096)
# (c) dataplane_bench.run at a size whose save interval (100 steps of a
# few ms) clears a 24 MB commit (~140 ms blocking), so the stalls order by
# the submit protocol, not by the writer's backpressure; batch 512 keeps
# the host's batch generation (numpy's normals, ~45 ms a step at 4096)
# from setting the step.
DATAPLANE_RUN = dict(steps=400, checkpoint_every=100, dim=512, batch=512, feed_steps=60)
# The fused Adam's state on the card: two weights, two moments each, two
# step counts; an eager async save reads each back on the step thread.
DATAPLANE_STATE_TENSORS = 8
# The staged cell with a planted blocking copy: two saves.
DATAPLANE_PLANTED = dict(steps=4, checkpoint_every=2, dim=512, batch=512, prefetch_depth=2)


def _hf_state_dict(cfg, seed: int = 0):
    """A seeded HF-layout ``LlamaForCausalLM`` state dict of ``cfg``'s
    shapes, bf16 on the card."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)

    def w(*shape, mean=0.0, std=IMPORT_STD):
        return (mean + std * torch.randn(*shape, generator=g, device="cuda")).to(torch.bfloat16)

    H, K, hd, D, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model, cfg.d_ff
    sd = {
        "model.embed_tokens.weight": w(cfg.vocab_size, D),
        "model.norm.weight": w(D, mean=1.0, std=0.1),
        "lm_head.weight": w(cfg.vocab_size, D),
    }
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = w(D, mean=1.0, std=0.1)
        sd[p + "post_attention_layernorm.weight"] = w(D, mean=1.0, std=0.1)
        sd[p + "self_attn.q_proj.weight"] = w(H * hd, D)
        sd[p + "self_attn.k_proj.weight"] = w(K * hd, D)
        sd[p + "self_attn.v_proj.weight"] = w(K * hd, D)
        sd[p + "self_attn.o_proj.weight"] = w(D, H * hd)
        sd[p + "mlp.gate_proj.weight"] = w(F, D)
        sd[p + "mlp.up_proj.weight"] = w(F, D)
        sd[p + "mlp.down_proj.weight"] = w(D, F)
    return sd


def _hf_forward(sd, cfg, tokens):
    """The plain HF-convention Llama forward in f32 (tests/test_llama_import.py:
    66-109 on the card): RMSNorm, rotate-half RoPE, GQA causal softmax
    attention, SwiGLU, the head; each weight widened to f32 where used."""
    import torch

    B, S = tokens.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def W(name):
        return sd[name].float()

    def rms(x, name):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + cfg.rms_eps) * W(name)

    half = hd // 2
    freqs = cfg.rope_theta ** (-torch.arange(0, half, dtype=torch.float32, device="cuda") / half)
    ang = torch.arange(S, dtype=torch.float32, device="cuda")[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]

    def rope(x):
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    x = W("model.embed_tokens.weight")[tokens]
    mask = torch.tril(torch.ones(S, S, dtype=torch.bool, device="cuda"))
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        y = rms(x, p + "input_layernorm.weight")
        q = rope((y @ W(p + "self_attn.q_proj.weight").T).view(B, S, H, hd))
        k = rope((y @ W(p + "self_attn.k_proj.weight").T).view(B, S, K, hd))
        v = (y @ W(p + "self_attn.v_proj.weight").T).view(B, S, K, hd)
        s = torch.einsum("bskgd,btkd->bkgst", q.view(B, S, K, H // K, hd), k) / hd ** 0.5
        probs = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(B, S, H * hd)
        x = x + out @ W(p + "self_attn.o_proj.weight").T
        y = rms(x, p + "post_attention_layernorm.weight")
        h = torch.nn.functional.silu(y @ W(p + "mlp.gate_proj.weight").T) * (y @ W(p + "mlp.up_proj.weight").T)
        x = x + h @ W(p + "mlp.down_proj.weight").T
    return rms(x, "model.norm.weight") @ W("lm_head.weight").T


def _imported_model(sd, cfg):
    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.models.llama_import import import_hf_llama_state_dict

    model = llama_lib.Llama(cfg, device="meta")
    model.load_state_dict(import_hf_llama_state_dict(sd, cfg), assign=True)
    return model.requires_grad_(False).eval()


def _import_parts(kernels):
    """(a): import at the 8B's width, logits against the HF forward, generate,
    the export round trip."""
    import dataclasses

    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.models.llama_import import (
        export_hf_llama_state_dict,
        import_hf_llama_state_dict,
    )
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = llama_lib.llama3_8b(n_layers=IMPORT_LAYERS, dtype=torch.float32)
    sd = _hf_state_dict(cfg32)
    B, S = IMPORT_CHECK
    toks = torch.randint(0, cfg32.vocab_size, (B, S), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    gaps = {}
    with torch.no_grad():
        ref = _hf_forward(sd, cfg32, toks)
        swapped = dict(sd)
        a, b = (f"model.layers.{i}.self_attn.q_proj.weight" for i in (0, 1))
        swapped[a], swapped[b] = sd[b], sd[a]
        for tag, weights in (("sound", sd), ("q_proj of layers 0 and 1 swapped", swapped)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = _imported_model(weights, cfg32)
            torch.cuda.synchronize()
            import_s = time.perf_counter() - t0
            logits = model(toks)
            if logits.shape != ref.shape or not torch.isfinite(logits).all():
                _fail(f"imported 8B-width logits of shape {tuple(logits.shape)}, or non-finite")
            gaps[tag] = (logits - ref).abs().max().item()
            agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
            _log(f"import f32 ({tag}): {import_s:.3f} s, logits vs the HF forward max_abs_err "
                 f"{gaps[tag]:.3e} (tol {IMPORT_LOGITS_ATOL}), argmax agreement {agree:.4f}, "
                 f"logit scale {ref.abs().max().item():.3f}")
            del model, logits
    del ref, swapped
    if gaps["sound"] > IMPORT_LOGITS_ATOL:
        _fail("the imported 8B-width Llama disagrees with the HF forward")
    if gaps["q_proj of layers 0 and 1 swapped"] <= IMPORT_LOGITS_ATOL:
        _fail("a swapped mapping read within the import's tolerance")
    torch.cuda.empty_cache()

    # The serving path: the import into the serving model's config (f32
    # parameters, as generate.load_params builds it) timed with its peak,
    # the matmul weights cast to bf16 once, then generate.
    G = IMPORT_GEN
    cfg = llama_lib.llama3_8b(n_layers=IMPORT_LAYERS, decode=True,
                              max_decode_len=G["prompt_len"] + G["new_tokens"])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = import_hf_llama_state_dict(sd, cfg)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    n_bytes = sum(t.numel() * t.element_size() for t in params.values())
    _log(f"import at Llama-3-8B width ({IMPORT_LAYERS} layers) into f32 parameters on the card: "
         f"{import_s:.4f} s, {n_bytes / 2**30:.3f} GiB written, peak {peak / 2**30:.3f} GiB "
         f"above the bf16 state dict")
    model = llama_lib.Llama(cfg, device="meta")
    model.load_state_dict(params, assign=True)
    del params
    model.cast_matmul_weights_().requires_grad_(False).eval()
    prompt = torch.randint(0, cfg.vocab_size, (G["batch"], G["prompt_len"]), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(2))
    gen = generate.make_generate(model, max_new_tokens=G["new_tokens"])
    cache = generate.init_cache(model, G["batch"])
    fa.reset_launch_count()
    t0 = time.perf_counter()
    out, _ = gen(cache, prompt, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = fa.launch_counts()
    _record_launches(kernels, "import_generate", launches)
    _log(f"generate from imported weights: {tuple(out.shape)} tokens in {gen_s:.3f} s "
         f"(first call), launches {launches}")
    if out.shape != (G["batch"], G["new_tokens"]) or not (
            0 <= int(out.min()) and int(out.max()) < cfg.vocab_size):
        _fail(f"generated tokens of shape {tuple(out.shape)} outside [0, {cfg.vocab_size})")
    if launches["flash_fwd"] != IMPORT_LAYERS:
        _fail(f"flash_fwd launched {launches['flash_fwd']} times in generate's prefill, "
              f"expected {IMPORT_LAYERS} (one a layer)")

    # The export round trip, bit for bit, on the card: the serving model's
    # weights back to the HF dict's values, and imported again (bf16
    # parameters: no widening) equal to the import of the HF dict.
    exported = export_hf_llama_state_dict(model, cfg)
    bad = [k for k in sd if exported[k].dtype != torch.float32 or not torch.equal(exported[k], sd[k].float())]
    cfg16 = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    back, want = import_hf_llama_state_dict(exported, cfg16), import_hf_llama_state_dict(sd, cfg16)
    bad += [k for k in want if not torch.equal(back[k], want[k])]
    if bad or set(exported) != set(sd):
        _fail(f"the export round trip is not exact: {bad[:4]}")
    _log(f"export round trip exact on the card: {len(exported)} tensors")
    del exported, back, want
    del model, cache, gen, sd
    torch.cuda.empty_cache()


def _flop_count_part():
    """(b): phase 5's training step counted on meta tensors."""
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.ops.flop_count import count_flops
    from pytorch_operator_tpu_torch.workloads import trainer

    cfg = llama_lib.llama_0_3b()
    model = llama_lib.Llama(cfg, device="meta")
    step = trainer.make_lm_train_step(model, trainer.make_optimizer(model.parameters(), 3e-4))
    launches = fa.launch_counts()
    t0 = time.perf_counter()
    fc = count_flops(step, torch.empty(*FLOP_COUNT_SHAPE, dtype=torch.long, device="meta"))
    count_s = time.perf_counter() - t0
    flash = sum(fc.by_kernel.values())
    _log(f"count_flops of phase 5's step (0.3b, B{FLOP_COUNT_SHAPE[0]} x {FLOP_COUNT_SHAPE[1]}, "
         f"AdamW) on meta tensors: total {fc.total:.6e} FLOPs, matmul share "
         f"{fc.by_primitive['dot_general'] / fc.total:.4f}, flash share {flash / fc.total:.4f} "
         f"({ {k: f'{v:.4e}' for k, v in fc.by_kernel.items()} }), {count_s:.2f} s")
    if fa.launch_counts() != launches:
        _fail("the FLOP count launched a kernel")
    if set(fc.by_kernel) != {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"} or not fc.total > 0:
        _fail(f"the FLOP count missed the flash calls: {fc.by_kernel}")


def _dataplane_part():
    """(c): dataplane_bench.run once on the card."""
    from pytorch_operator_tpu_torch.workloads import dataplane_bench

    r = dataplane_bench.run(**DATAPLANE_RUN, device="cuda", log=_log)
    for c in r["cells"]:
        _log(f"dataplane {c['ckpt']}/{c['feed']}: {c['steps_per_sec']} steps/s, stall p50 "
             f"{c['stall_ms_p50']} ms p99 {c['stall_ms_p99']} ms, verified step "
             f"{c['last_verified_step']} of {c['last_saved_step']}, step-thread puts "
             f"{c['step_thread_device_puts']}, fetches beyond budget "
             f"{c['step_thread_gets_beyond_budget']}")
    _log(f"dataplane comparisons: {json.dumps(r['comparisons'])}")
    by = {(c["ckpt"], c["feed"]): c for c in r["cells"]}
    if not all(c["all_saves_verified"] for c in r["cells"]):
        _fail("a data-plane cell ended with an unverified save")
    if any(by[(ck, "prefetched")]["step_thread_device_puts"] for ck in ("blocking", "async", "staged")):
        _fail("a prefetched cell put on the step thread")
    eager = {fd: by[("async", fd)] for fd in ("inline", "prefetched")}
    if r["comparisons"]["staged_step_thread_gets_beyond_budget"] or any(
            c["step_thread_gets_beyond_budget"] != DATAPLANE_STATE_TENSORS * c["saves"]
            for c in eager.values()):
        _fail("the staged cells fetched on the step thread, or the eager ones did not fetch "
              f"each of the {DATAPLANE_STATE_TENSORS} state tensors a save")
    if not r["comparisons"]["autotuned_depth_within_max"]:
        _fail("the autotuned feed outgrew depth_max")
    stall = {ck: by[(ck, "inline")]["stall_ms_p50"] for ck in ("blocking", "async", "staged")}
    if not stall["staged"] < stall["async"] < stall["blocking"]:
        _fail(f"checkpoint stalls out of order (staged < async < blocking expected): {stall}")

    # The meter can fail on the card: the staged submit regressed to a
    # blocking copy into its pinned buffers (``copy_`` without
    # ``non_blocking``), one read a state tensor a save on the step thread.
    import torch

    from pytorch_operator_tpu_torch.checkpoint import manager

    def blocking_stage(tree):
        def stage(x):
            if isinstance(x, dict):
                return {k: stage(v) for k, v in x.items()}
            if isinstance(x, torch.Tensor):
                return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
            return x

        held = stage(tree)
        return lambda: held

    real_stage = manager.stage_mutable_leaves
    manager.stage_mutable_leaves = blocking_stage
    try:
        c = dataplane_bench.bench_cell(ckpt_mode="staged", feed_mode="inline", **DATAPLANE_PLANTED,
                                       work_dir=None, device="cuda", log=_log)
    finally:
        manager.stage_mutable_leaves = real_stage
    _log(f"dataplane planted blocking staged copy: fetches beyond budget "
         f"{c['step_thread_gets_beyond_budget']} over {c['saves']} saves, verified step "
         f"{c['last_verified_step']} of {c['last_saved_step']}")
    if c["step_thread_gets_beyond_budget"] != DATAPLANE_STATE_TENSORS * c["saves"] or not c["saves"]:
        _fail("the meter missed the planted blocking copies in the staged submit")


def phase_import_flops_dataplane(kernels):
    """Phase 17: (a) the HF weight import through generate at Llama-3-8B's
    width, (b) the FLOP count of phase 5's step, (c) the data-plane bench."""
    t_phase = time.perf_counter()
    for part, run in (("(a)", lambda: _import_parts(kernels)), ("(b)", _flop_count_part),
                      ("(c)", _dataplane_part)):
        t0 = time.perf_counter()
        run()
        _log(f"import/flops/dataplane {part}: {time.perf_counter() - t0:.1f} s")
    _log(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    return None


def main() -> int:
    t_start = time.perf_counter()
    card = phase_identity_and_build()
    kernels = phase_flash_vs_plain() + phase_backward_vs_plain()
    _log(f"phases 1-3: {time.perf_counter() - t_start:.1f} s")
    # Each path's profile runs after every timed run: no timed run follows
    # a profiler session.
    profiles = []
    for phase in (phase_generate, phase_train, phase_serve, phase_int8, phase_journey, phase_rest,
                  phase_moe, phase_dist, phase_image, phase_tp, phase_sp_ep, phase_pp,
                  phase_mnist_bert, phase_import_flops_dataplane):
        t0 = time.perf_counter()
        profiles.append(phase(kernels))
        _log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    for run_profile in filter(None, profiles):
        t0 = time.perf_counter()
        run_profile()
        _log(f"{run_profile.__qualname__}: {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        k["launches"] = sum(k["launches_by_path"].values())
        if k["launches"] == 0:
            _fail(f"kernel {k['name']} never ran on a main path")

    import torch

    _log(f"whole run: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        # One rank of a phase-11 world, started by _rank_world.
        sys.exit(_rank_main(sys.argv[2], json.loads(sys.argv[3])))
    sys.exit(main())
