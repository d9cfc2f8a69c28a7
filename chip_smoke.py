#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (garbage_classification_rca_tpu_torch).

    python3 chip_smoke.py        # needs one NVIDIA GPU; ~15 minutes

Phases, each of which fails the run when it fails:
  1. device: the card's name and power limit;
  2. build: nvcc compiles every csrc/*.cu for sm_90a, one process per
     source, all started together;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main paths' shapes and edge cases, with the tolerances below;
     kernel / plain / library-call times from CUDA graphs timed with CUDA
     events after a warm-up (median of 5); for the bf16 blocks on the
     tensor cores also each kernel's time from the profiler (MLP, K5b /
     K6b: GEMM1, GEMM2, LayerNorm pass; attention, K5a / K6a: LayerNorm
     pass, QKV GEMM, per-head core, out-projection GEMM), the share of the
     bound, and K6a / K6b at ViT-L/16's full width; the bf16 attention
     blocks' CUDA-core body held to the same plain version and timed
     against the tensor-core route in one call (new-old-old-new);
     the flash pair's tensor-core route (K4a / K4b in bf16 at head dim 64,
     N <= 256: ``mha_fwd_lse_tc`` / ``mha_flash_bwd_tc``) at N = 1 .. 256
     unmasked, key-masked with a fully masked sample, and causal, its
     gradients bit-identical over two runs, and timed against the CUDA-core
     kernels in one call (new-old-old-new) at 128x197x768 (ViT-B/16 train)
     and 128x64x768, beside the plain pair, the library call and the
     bound; K2's tensor-core route (``mha_tc``, the same bf16 forward
     without lse) the same way at N = 1 .. 256, timed against the CUDA-core
     K2 at 128x64x768 masked and 128x197x768 beside SDPA; the fp32
     training pair's 3xTF32 routes (``mha_fwd_lse_drop_tc32``,
     ``mha_flash_bwd_tc32``, ``mha_flash_bwd_drop_tc32``: K7a and K4b /
     K7b at head dim 64, N <= 64; K4a's 3xTF32 forward, on request only,
     reported with the ``mha_fwd_lse`` row) beside the CUDA-core kernels
     on every fp32 case, bit-identical over two runs, the forwards timed
     new-old-old-new at 16x64x768, 128x64x768 and 128x64x768 with p 0.1,
     beside the plain versions, the library call, the bound and the share
     of the bound reached; K1 (``rca_fused``) at B = 128, 13, 1 (fp32,
     bf16) and 16 (t fp32, i bf16; fp32 and bf16 weights) and K3
     (``rca_fused_bwd``) at B = 16, 13, 1, 64, each on its staged route
     against the plain version and, bit for bit, against its per-sample
     route; K1 timed new-old-old-new at B = 128 bf16 and at B = 16 in the
     training mix, K3 at B = 16, each stage kernel's time from the
     profiler; the build's ptxas report (registers, spills) per kernel;
  4. eval: the MM-RCA eval path (EfficientNetV2-M at 480x480, 6-layer
     DistilBERT at seq 64, the MM-RCA block, eval batch 128, bf16) with
     random seeded weights over synthetic batches through ``run_eval``;
     launch counters zeroed before and read after that run (K1 on its
     staged route, K2 on the tensor cores); logits against the same model
     on the plain versions;
     samples/s, p50 batch latency, peak memory; one batch of 8 at
     ``--seq_len=512``, where K2 runs on the CUDA cores;
  5. train: the MM_RCA.sh recipe at full width (fp32 master weights, bf16
     images, batch 16 x acc_steps 10, SGD lr 0.0016 reg 0.03, class
     weights, augmentation p=1.0, head dropout 0.6, stochastic depth) —
     three optimizer steps all trainable and one with the phase-1 mask,
     launch counters read around them (per microbatch: K1 1, K3 1, both
     staged, K4a 6 on the CUDA cores, K4b 6 on 3xTF32); steps/s,
     samples/s, peak memory, a profiler breakdown; one more step with
     ``hf_internal_dropout`` (per microbatch K1 1, K3 1, K7a 6, K7b 6 on
     3xTF32); a microbatch's loss and gradients on the kernel path
     against the plain path, on the seeded weights restored after the
     steps; then
     ``cli.main_both`` with the MM_RCA.sh flags for 1 + 1 epochs on a
     synthetic 480x480 JPEG tree and ``cli.test_both`` on its
     BEST checkpoint: ``evaluate()``, then ``main()`` end to end, whose
     report CSV must carry the same accuracy;
  6. text eval: BERT-base at full width and depth (12 layers, seq 64,
     batch 256, bf16, random seeded weights, WordPiece ids) through
     ``run_eval`` with ``cli.test_text``'s step: launches per batch K5a 12
     (all on the tensor cores), K5b 12, K2 0; logits against the plain
     path (bf16, and fp32 with TF32 off); samples/s, p50, peak memory, a
     profiler breakdown; one batch each of DistilBERT (6 + 6 launches) and
     RoBERTa (12 + 12);
  7. image eval: ViT-B/16 at full width and depth (batch 64, 224x224,
     bf16) through ``run_image_eval``: K6a 12 (tensor cores) and K6b 12
     per batch, the same readings; then ``cli.test_text`` (DistilBERT) and
     ``cli.test_image`` (ViT-B/16) evaluate reference-layout ``.pth`` files
     on a synthetic JPEG tree;
  8. text train: the DistilBERT classifier at full width and depth (batch
     128, seq 64, fp32, SGD, head dropout 0.6, class weights) with
     ``--hf_internal_dropout``: three steps all trainable and one head
     only, per microbatch K7a 6, K7b 6 (3xTF32), K4a 0, K4b 0; a step with
     the flag off (K4a 6 on the CUDA cores, K4b 6 on 3xTF32, K7 0); a step
     of BERT-base with the flag (12 + 12);
     one microbatch's loss and gradients on the kernel path against the
     plain path from the same key; steps/s, samples/s, peak memory, a
     profiler breakdown, and the step's device time with both kernels on
     3xTF32, both on the CUDA cores, and the 3xTF32 backward beside the
     CUDA-core forward (``flash_routes``), in turns;
     a step at ``--seq_len=512`` (batch 8) with the flag and without, where
     K7a / K7b and K4a / K4b run on the CUDA cores, and its gradients
     against the plain path; then ``cli.main_text --hf_internal_dropout`` for
     1 + 1 epochs on a synthetic tree and ``cli.test_text`` on its BEST
     file (``evaluate()`` and ``main()``), and on that file the bf16
     kernel path against the plain path and the fp32 model
     (``best_file_agreement``: the agreement over every sample beside the
     one above the noise floor, recorded);
  9. image train: ViT-B/16 at full width and depth (batch 128, 224x224,
     bf16 images over fp32 master weights, augmentation p=1.0): K4a 12 and
     K4b 12 per microbatch, all on the tensor-core route, the same
     readings; ``cli.main_image`` (its val eval: K2 on the tensor cores) ->
     ``cli.test_image`` (``evaluate()`` and ``main()``), and
     ``best_file_agreement`` on its BEST file;
 10. conv image eval: the 12 conv backbones of the registry (ShuffleNetV2
     x2.0, ResNet-18 / 50 / 152, MobileNetV3-L, ConvNeXt-B, EfficientNet
     B0 / B4 / B5, EfficientNetV2 S / M / L) at full width with random
     seeded weights and BatchNorm statistics, on cuDNN convolutions and
     PyTorch ops (no hand-written kernel): for each, on 32 images at its
     ``IMAGE_ARCHS`` input size, the BN-folded model against the unfolded
     one in fp32 (TF32 off) and in bf16 against itself in fp32
     (``bf16_vs_fp32``); ShuffleNetV2 in bf16, BN folded, through
     ``run_image_eval`` (8 batches of 256, 224x224) with the counters
     zeroed before and read after (every hand-written kernel 0): samples/s,
     p50, peak memory, a profiler breakdown (convolutions, elementwise,
     copies / casts / transposes) and the idle share, the same runs with
     ``cudnn.benchmark`` on (the phase leaves it off), one batch of 512;
     one timed batch of each other model at its eval batch and input size;
     then ``cli.test_image --image_model=shuffle_net`` on a
     torchvision-layout ``.pth`` (``evaluate()`` and ``main()``);
 11. fusion eval: the late-fusion heads at full width with random seeded
     weights, on one EfficientNetV2-M at 480x480 (random BN statistics,
     folded) and three text towers (DistilBERT 6 layers, BERT-base 12,
     BART-large 12 + 12), seq 64, bf16, built once and shared by the
     heads: gated, classic, normalized, hierarchical and bimodal with
     DistilBERT over 2 batches of 128, clip over 2 batches of 16
     (``--batch_size``); gated, MM_RCA and hierarchical with BERT and
     classic and clip with BART, one timed batch each. Per run: the fp32
     kernel path against the plain path on 16 samples, the bf16
     ``run_multimodal_eval`` with the counters zeroed before and read
     after (K2 6 a DistilBERT batch, 12 a BERT batch, 0 with BART; K1 1 a
     batch on the BERT MM_RCA run; every other 0; their sum is the
     ``fusion_eval`` path), samples/s, p50, peak memory, device ms (each
     tower's first run), the
     bf16 kernel path against the plain path (BART: bf16 against fp32) and
     a split of one batch by CUDA events: towers / head, the bimodal GRU
     scan on its own with its launches from the profiler; then
     ``cli.test_both`` with the default --late_fusion (gated) and with
     --late_fusion=clip on BEST files written from random port models
     (``evaluate()`` with its launches, ``main()``), and ``cli.test_text
     --text_model=bart`` ``evaluate()`` on a
     ``BartForSequenceClassification``-layout ``.pth`` of the same BART;
 12. VLM eval: BLIP-2 (blip2-opt-2.7b: EVA ViT-g 39 layers of 1408,
     Q-Former 12 of 768, OPT-2.7B 32 of 2560; 3.74 B parameters) at full
     width and depth on random seeded weights, adapters with B != 0, a
     Q-Former classifier, fp32 and bf16 copies, over seeded 224x224 images
     and hash-tokenized knowledge prompts left-padded to 100: K2 at the
     path's two shapes (EVA 16 x 257 x 1408, 16 heads of 88, unmasked; OPT
     16 x 132 x 2560, 32 heads of 80, causal with the left-pad mask; with
     a fully masked sample and a single-key one) against its plain
     version: fp32 on the CUDA cores, bf16 on the tensor cores (the
     default; also at N = 1 and with a sample whose first 100 keys are
     pads) and on the CUDA cores (``route="cuda_core"``) on the same
     inputs; both bf16 routes timed new-old-old-new beside the plain
     version, SDPA with the equivalent additive bias and the bound; the
     fp32 and bf16 kernel
     paths against the plain path (next-token logits over the four answer
     tokens, classifier logits) with K2's launches counted (71 a BLIP-2
     batch, 39 a Q-Former batch); BLIP-2 eval at batch 16 and 8 and the
     Q-Former eval at 16 through ``vlm_eval`` with the counters zeroed
     before and read after: samples/s, p50, peak memory, device ms, idle
     share, K2's share, the EVA / Q-Former / OPT split by CUDA events;
     then ``cli.blip2_test`` and ``cli.qformer_test`` ``main()`` on a 4 x 4
     JPEG tree from the phase's weights written as a peft-wrapped HF
     ``.pth`` and a MultimodalClassifier ``.pth``;
 13. VLM train: K4a / K4b at OPT-2.7B's LoRA shape (16 x 136 x 2560, 32
     heads of 80, causal, the path's left-pad mask; a fully masked and a
     single-key sample; N = 1) against the plain pair in fp32 (the CUDA
     cores) and bf16 (the default plan, K4a and K4b on the tensor cores,
     also with a sample whose first 100 keys are pads; and the CUDA-core
     pair on request, on the same inputs), the bf16 K4a and K4b each
     timed on both routes new-old-old-new, beside the plain pair, the
     library's efficient attention with the equivalent additive bias (and
     its backward) and the bound, the tensor-core K4b bit-identical over
     two runs; BLIP-2 LoRA training at full
     width and depth (phase 12's
     seeded towers in bf16, fp32 adapters with B != 0, microbatch 16 x acc
     8): one warm-up optimizer step and two timed with the counters zeroed
     before and read after (per microbatch K2 39, K4a 32, K4b 32, all on
     the tensor cores, the rest 0), train samples/s, steps/s, peak
     memory, a profile (device ms a step, idle share, K2 / K4a / K4b /
     GEMMs / elementwise); one step
     with ``hf_internal_dropout`` (the same launches, not profiled); a
     microbatch's loss
     and adapter gradients on the kernel path against the plain path, bf16
     at 16 and fp32 at 4; the Q-Former classifier's step at 16 x 8 (K2 39
     a microbatch); then ``cli.blip2_train`` and ``cli.qformer_train`` for
     one epoch from phase 12's ``.pth`` on a 16 + 16 JPEG tree, their
     launches counted, and ``cli.blip2_test`` / ``cli.qformer_test`` on
     the BEST files they wrote; then RESUME: both trainers at full width
     (the BLIP-2 base from ``--seed``, bf16, fp32 adapters) on 20 + 4
     JPEGs at ``--batch_size=2`` (2 windows an epoch), 2 epochs with
     ``--resume_every_steps=1``, run twice uninterrupted, then killed at
     epoch 1's first window (RESUME holds epoch 0's end) and at its second
     (RESUME holds one window) and resumed with ``--resume_from``: each
     resumed run bit-identical to the uninterrupted one where the two
     uninterrupted runs are, else no further apart (``_resume_case``); the
     resumed LoRA runs launch K2, K4a and K4b, the Q-Former's K2.

 14. late-fusion train: every pair the JAX package trains but MM-RCA on
     DistilBERT (phase 5's) — gated, classic, normalized, clip,
     hierarchical and bimodal on DistilBERT (6 layers) and BERT-base (cut
     to 4 of 12), MM_RCA on BERT, gated, classic, normalized and clip on
     BART-large (cut to 1 + 1 of 12 + 12) — at full width on
     EfficientNetV2-M at 480x480, seq 64, towers
     built once (random seeded weights and BN statistics, unfolded) and
     restored to their seeds for each pair, fp32 master weights, bf16
     images, batch 16 x acc 2 (MM_RCA.sh's acc 10, cut), SGD lr 0.0016 reg
     0.03, class weights, augmentation p=1.0, head dropout 0.6: per pair
     one microbatch's loss and gradients on the kernel path against the
     plain path with phase 5's bars, one optimizer step with the counters
     zeroed before and read after (per microbatch K4a 6 / 5 on the CUDA
     cores, K4b 6 / 5 on 3xTF32 on DistilBERT / BERT, K1 1 and K3 1 on
     MM-RCA, nothing on BART), train samples/s, peak memory, on each
     tower's first pair a profiled step (device ms, idle share, time by
     kind); one more step with
     ``hf_internal_dropout`` on gated + DistilBERT, hierarchical + BERT
     (K7a / K7b in place of K4a / K4b) and classic + BART, whose loss the
     flag must change and repeat from the same key; then ``cli.main_both
     --late_fusion=hierarchical --text_model=bert``, ``cli.main_both
     --late_fusion=clip --text_model=bart --batch_size=16`` and
     ``cli.main_text --text_model=bart`` for 1 + 1 epochs on a 32 + 32
     480x480 JPEG tree in fp32, launches counted, into ``cli.test_both`` /
     ``cli.test_text``, whose accuracy on each BEST file must equal the
     trainer's best val accuracy.

 15. text family: GPT-2 (12 x 768, vocabulary 50,257) and MobileBERT (24
     layers, 512 / 128, vocabulary 30,522), the last two text backbones,
     at full width and depth with random seeded weights, seq 64. Neither
     runs a hand-written kernel (the JAX modules compute their attention
     with plain einsums): every kernel counter must read 0 over each run.
     Per model: fp32 (TF32 off) on the card against the same model on the
     CPU on 8 samples, within 1e-4 of the largest |logit|; ``run_eval``
     with ``cli.test_text``'s step in bf16 at its eval batch (128 / 256)
     over 4 batches, three runs (samples/s, p50, peak memory) and a
     profile; bf16 against fp32 on the first batch, recorded with its
     near-tie count (``bf16_vs_fp32``); one timed train step at the
     recipe's envelope (GPT-2 4 x acc 12, MobileBERT 64), fp32 masters,
     all trainable, with and without ``hf_internal_dropout``. Then
     ``cli.main_text --hf_internal_dropout`` for 1 + 1 epochs on a 32 + 32
     tree into ``cli.test_text`` ``evaluate()`` and ``main()`` on its BEST
     file (fp32: the trainer's best val accuracy, and the report carries
     it), and ``cli.test_text --param_dtype=bfloat16
     --compute_dtype=float32`` on it (bf16 weights).
 16. conv train and resume: the 12 conv backbones of phase 10 in train
     mode (cuDNN convolutions, BatchNorm on batch statistics; no
     hand-written kernel: every counter must read 0) at full width and
     depth, random seeded weights and BN statistics, fp32 master weights,
     bf16 images, augmentation at ``cli.main_image``'s default p, SGD, class
     weights: per model one timed all-trainable step at its ``IMAGE_ARCHS``
     input size, microbatch ``ft_batch`` x acc 2 (the recipes' 0 to 24
     accumulation steps, cut to 2), and for the six 224x224 models one
     phase-1 step (head only) at ``train_batch`` x 2; samples/s, peak
     memory, and on ``CONV_PROFILED`` device ms a step, idle share and a
     profiler split (convolutions, elementwise, copies). Then, on each
     family's smallest
     member (res18, shuffle_net, mb, convnext, b0), one train microbatch of
     2 (TF32 off, no random draw) on the card against the same
     model on the CPU, in fp64 and in fp32: every fp64 gradient within
     1e-4 of its tensor's largest |g| (a BatchNorm bias whose gradient
     is zero in exact arithmetic sized against its scale's, as phase 5
     sizes them); in fp32 the loss, the new running statistics within
     1e-4 of their largest value, and the gradients of the smooth towers
     (ConvNeXt, b0) as in fp64 (``CONV_FP32_GRADS`` says why the ReLU
     towers' fp32 gradients are reported, not held).
     Then ``cli.main_image --image_model=res18`` for 1 + 1 epochs on a
     32 + 32 224x224 JPEG tree (fp32, TF32 off) into ``cli.test_image``
     (``drive_eval_main``), which must report the trainer's best val
     accuracy; and RESUME held to a control: ``cli.main_both
     --late_fusion=MM_RCA`` at full width (16 + 8 480x480 JPEGs, batch 4 x
     acc 2, ``--resume_every_steps=1``) run twice uninterrupted (the
     control: the largest difference between the two final states and
     logged losses), a third time killed at the second window of its
     second epoch (the train step raises) and resumed from
     ``model_weights/MM_RCA_distilbert/RESUME``: the resumed run's final
     state and losses must be bit-identical to the first run's if the
     control is, else within it; K1, K2, K3, K4a and K4b must each launch
     over the resumed run. The same at an epoch boundary on the res18
     trainer above.
 17. serving: BLIP-2 generation at blip2-opt-2.7b's full width and depth
     in bf16 (random towers from ``--seed`` through ``build_blip2``,
     adapters with B != 0, written as a BEST file for the CLIs) over
     phase 12's kind of prompts (left-padded to 100, 132 with the query
     tokens), K2 in every prefill: ``blip2.generate`` at batch 16, 32 new
     tokens, the kernel path against the plain path (each K / V cache
     layer on the valid slots to the blocks' bf16 bar, or past it no
     further than the one-ulp control moves it (below), the first-step
     logits as phase 12's, the greedy streams up to the first near tie);
     fp32 at batch 4 (streams identical, first-step logits within 1e-4 of
     max |logit|); the int8 cache and int8 weights, each kernel path
     against its plain path; the int8 cache against the bf16 run as the
     JAX package's ``tests/test_quant.py`` holds it, at that test's depth
     (OPT cut to 3 layers at full width: one decode step's hidden within
     2% of its largest |value|); int8 weights by their own bounds (each
     dequantized weight within half a step of its bf16 weight; an int8
     projection within the blocks' bf16 bar of the fp32 product of its
     dequantized weights); the first-step logits' and full depth's moves
     recorded beside a one-ulp control (the prompt embeddings moved by
     N(0, 1) bf16 ulps); the
     ``GenerationServer`` at the config defaults (8
     slots, max_prompt 100, 8 steps a sync, max_new 32) on 24 requests,
     half image, half text, budgets 1 to 32, an EOS taken from inside a
     stream: every stream equal to its request's own B = 1 ``generate`` up
     to the first near tie, slots retired and refilled, the counters zeroed
     before and read after (the ``serving`` path: K2 32 a prefill); tokens
     / s, time to first token, p50 / p95 request latency, decode ms a
     step, a profile of 8 decode steps (device ms, idle share, device
     operations a step), peak memory; ``speculative_generate`` in fp32 at
     batch 4 (the full OPT-2.7B target, a draft of OPT-125m's published
     widths with random weights, draft_k 4) equal to the target's greedy
     ``generate``; then ``cli.blip2_test --max_new_tokens=4`` (greedy,
     sampled, ``--int8_weights --kv_cache_dtype=int8``) on a 16-JPEG tree
     and ``cli.serve`` on 16 JSONL lines (a malformed line and a bad field
     among them): one answer a request, the error lines, the greedy
     answers against in-process ``generate``. A near tie: a step whose
     top-2 logit margin on the reference side is under a same-run floor
     (``near_tie_agree``): kernel against plain, the largest |d| of the two
     paths' first-step logits; a server row against its B = 1 run, the
     largest |d| between the B = 1 and the batched first-step logits of
     the same requests.
 18. paraphraser (no hand-written kernel, no counter): ``regex`` and
     ``jinja2`` import here; the Llama behind ``GC_RCA_LLM_PATH``
     (``models/text/llama``) at Llama-3.1-8B-Instruct's geometry in fp32,
     weights drawn on the card from the seed: ``generate`` of the
     reference's prompts of 8 sentences, rendered with a Llama-3-style
     template and tokenized by the BPE fixture's vocabulary with Llama-3's
     specials (at their Llama-3 ids), 6 new at temperature 0.4, top-k 50,
     top-p 0.9; prefill ms, decode ms a step, the device's idle share over a
     generate, peak memory, the same tokens twice from one seed; at full
     width and 2 layers, TF32 off, the card's logits of the 6 steps
     (prefill, cached decode) against the CPU's teacher-forced forward
     within max(1e-5, a one-ulp control) of max |logit|; then
     ``cli.main_text --text_model=distilbert --use_synonyms
     --prob_aug_text=1`` for one step with ``GC_RCA_LLM_PATH`` at a
     directory it writes (2 layers at full width, bf16, two safetensors
     shards and their index, the BPE fixture's vocabulary with Llama-3's
     specials and Split pattern, a Llama-3-style template of this
     script's): the paraphraser's parameters on the card, every sentence
     through it;
 19. data parallelism (``parallel/``; about 130-170 s): (a) the MM_RCA.sh
     step at full width (EfficientNetV2-M at 480x480, 6-layer DistilBERT,
     fp32 masters, class weights, augmentation, head dropout, stochastic
     depth, a padded row) on a global batch of 2 x 16 x acc 2 over two
     ranks sharing the card on gloo (``parallel.multihost.launch``, each
     rank ``python3 chip_smoke.py --dp_step=<spec>``), held to the
     one-rank step of the same global batch with fp32 images, cuDNN and
     TF32 off (loss 1e-5; gradients, updated weights and BN running
     statistics within 1e-4 of their scale or 1.5x the one-rank step's
     own one-ulp control, ``dp_compare``), each rank's counters showing
     K1, K3, K4a and K4b; then, in the recipe's bf16 images, train
     samples/s of the two ranks beside one rank's, peak memory per rank
     and the all-reduce's share of a profiled step (numbers of two ranks
     sharing one card); (b) ``cli.main_both`` (MM_RCA, 1 + 1 epochs) over
     two ranks on a synthetic 480x480 JPEG tree, its BEST file evaluated
     by a one-rank ``cli.test_both``, then ``cli.test_both`` over two
     ranks (``python3 chip_smoke.py --dp_eval <flags>``) on (a)'s seeded
     weights: accuracy, labels, predictions (more than one class) and
     the report CSV equal to a one-rank ``cli.test_both``'s; (c) one
     ``--fsdp`` step of ``cli.main_text`` (DistilBERT, SGD) in a process
     group of one rank on NCCL, held to the run without a group (the JAX
     FSDP tolerance, rtol 3e-4 / atol 1e-6). (a) also runs the step in
     the recipe's bf16 images on cuDNN in the same launch, held to the
     one-rank bf16 step within 1.5x its own one-ulp control and the loss
     within 1e-3 relative (at random weights a bf16 ulp on the images
     moves the worst gradients as far as the split over two ranks does:
     ``tools/dp_bf16_check.py``). Any rank's failure fails the phase; no
     group falls back to one process;
 20. tensor and sequence parallelism (``parallel/tp.py``, ``parallel/
     sp.py``; a budget of 150 s, printed): K2 at 16 x 132 x 1280 and K4a /
     K4b at 16 x 136 x 1280 (a rank's 16 heads of 80 at ``model:2``)
     held to their plain versions and timed; then one launch of two ranks
     sharing the card on gloo (``python3 chip_smoke.py --tp_worker=
     <spec>``), each building blip2-opt-2.7b in bf16 from the seed and
     slicing its OPT tower at ``model:2``: (a) the 1-token eval of 16
     prompts (the answer logits within 0.05 of one rank's, the argmax
     equal above the near-tie floor), (b) ``generate`` 16 x (32 + 100) +
     32 greedy (the streams equal to one rank's up to a near tie, and
     equal on both ranks), (c) a LoRA step, microbatch 16, acc 2, fp32
     adapters (the loss within 1e-3 relative or 1.5x a same-run one-ulp
     control, the adapter gradients within 1.5x that control), (d) the
     times and peak memory per rank beside one rank's (reported); then in
     the same processes (e) ``cli.serve --mesh_shape=data:1,model:2`` on 8
     of phase 17's requests (each line held to the one-rank server's by
     the near-tie rule, rank 0 alone writing) and (f) ``cli.test_text
     --text_model=distilbert --seq_len=512 --mesh_shape=seq:2`` on 24
     texts in bf16 (logits within 0.05 of one rank's, a prediction may
     differ only at a near tie, the report CSV), with each run's
     CUDA-event ms a batch.

Prints a ``{"kernels": [...]}`` line, the nvidia-smi name/power line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with
no result line, when CUDA is absent or any phase fails.

Tolerances (kernel vs plain version, same inputs, same card):
  * fp32: rca_fused |d| <= 2e-5 + 2e-5|x| (the JAX package's bar for this
    kernel); mha and mha_fwd_lse |d| <= 1e-5 + 1e-5|x|. They compute in
    fp32 and differ only in summation order. The backward kernels
    (rca_fused_bwd, mha_flash_bwd): |d| <= 5e-5 (1 + |x|), the JAX
    package's backward bar. The dropout pair (mha_fwd_lse_drop,
    mha_flash_bwd_drop) is held to its plain pair's limits, fp32 and bf16,
    on the same keep mask.
  * the fp32 training pair's 3xTF32 routes: K4a / K7a the fp32 forward bar
    1e-5 + 1e-5|x| on out and lse, K4b / K7b the fp32 backward bar above;
    their products carry about 2^-21 relative error each.
  * bf16: |d| <= one bf16 ulp of the value + 1e-5 (rca_fused: fp32 math,
    one final rounding that may land on either neighbour) and + 1e-3 for
    mha (its softmax weights are rounded to bf16 before the PV product,
    and a weight that rounds to the neighbouring bf16 value moves the
    output by at most its ulp times |v|); gradients: one ulp + 2e-3 of
    the tensor's largest |x| (a rounded dS element moves every sum it
    enters by about its ulp). The tensor-core route of K4a / K4b is held
    to these limits at the ViT-B/16 shape and at 128x64x768; in its edge
    cases (``_held_to_plain(edge=True)``) a row whose largest softmax
    weight w is large (a causal row with few keys) holds the output to one
    ulp + ulp(w) max|v| (one weight rounding the other way, since S is
    summed in another order), and at N = 1, where dQ and dK are zero in
    exact arithmetic, they are held to the rounding of the fp32 dot
    products they come from. K2's tensor-core route, the same kernel
    without lse, is held to the same one-flip limit everywhere (its S is
    summed in another order than the plain version's, so a weight near a
    bf16 boundary may round the other way); the number of elements over
    one ulp + 1e-3 is printed and reported beside it.
  * the fused transformer blocks (postnorm_attn_block, postnorm_mlp_block,
    attn_block, mlp_block): fp32 |d| <= 2e-5 + 2e-5|x| (fp32 sums in
    another order over K up to 3072); bf16 one ulp of the value + 1e-2 of
    the tensor's largest |x| (q / k / v, the softmax weights and the MLP
    hidden are rounded to bf16 inside the block, and an element that
    rounds to the neighbouring value moves every sum it enters).
  * eval model, bf16: argmax agreement >= 0.98 and max |logit difference|
    <= 0.05 between the kernel path and the plain path; fp32 (TF32 off):
    max |logit difference| <= 1e-4 and equal argmax. The same limits hold
    the text and image eval models. With random weights a unimodal text
    model's logits are near ties for many samples, and bf16 rounding alone
    can flip those argmaxes: the agreement is counted over the samples
    whose fp32 top-2 margin is above a noise floor, twice the largest
    |plain bf16 - fp32| logit difference of the run, and at least half the
    samples must lie above it; the samples under it are counted and
    printed, with the agreement over all samples beside them
    (``argmax_check``). The 0.05 bound on the logits holds for every
    sample.
  * train microbatches (``compare_train_paths``, two of them): fp32
    images, TF32 off, the loss within 1e-5 relative and every gradient
    within 1e-4 of its tensor's largest |g|; bf16 images, the loss within
    1e-3 relative and every gradient's cosine >= 0.999 (>= 0.998 in the
    bf16 image tower, whose gradients move that far when the RCA block's
    di moves by one bf16 ulp in a few elements — measured in the same run);
    biases whose gradient is rounding noise around an exact zero are held
    to their sibling weight's scale. The unimodal train paths
    (``compare_unimodal_paths``) are held the same way: fp32 1e-5 / 1e-4,
    bf16 images (ViT) 1e-3 and cosine >= 0.999.
  * fusion eval (phase 11): the DistilBERT / BERT runs as the eval model
    above, fp32 on 16 samples; in bf16, max |d| <= 0.05 and argmax
    agreement >= 0.98 over the samples above the noise floor, without the
    half-the-samples condition (``fusion_agreement`` says why); BART, which
    runs no kernel, bf16 against fp32 as phase 10's towers
    (``bf16_vs_fp32``), the CLIP head without the relative bar
    (``_kernel_less_check`` says why).
  * VLM eval (phase 12): K2 at head dims 88 / 80 on the CUDA cores to
    their bars (fp32 1e-5 + 1e-5|x|, bf16 one ulp + 1e-3), on the tensor
    cores to the one-flip limit of K2's tensor-core route above, with the
    count over one ulp + 1e-3 printed; the fp32 kernel path
    against the plain path within 1e-4 of the largest |logit| (the
    next-token logits come out of a 50272-wide tied lm head over 32 + 39
    layers: an absolute 1e-4 has no scale); bf16 as phase 11
    (``fusion_agreement``: 0.05, and 0.98 above the noise floor).
  * VLM train (phase 13): K4a / K4b at head dim 80 to the flash pair's
    bars above (fp32 1e-5 + 1e-5|x| and 5e-5 (1 + |x|); bf16 one ulp +
    1e-3 and one ulp + 2e-3 max; at N = 1 in bf16 dQ / dK held to the
    rounding of their two dot products, as the tensor-core route's edge
    cases; the tensor-core K4a's output to the one-flip limit, its lse to
    1e-5 + 1e-5|x|; the tensor-core K4b, the default in bf16, at the bf16
    bars and bit-identical over two runs); the LoRA microbatch, kernel
    path against the same
    path with OPT's flash pair on its plain versions (EVA on K2 on both
    sides), with the train bars: fp32 (TF32 off) loss within 1e-5 relative
    and every adapter gradient within 1e-4 of its tensor's largest |g|,
    bf16 loss within 1e-3 relative and every gradient's cosine >= 0.999; a
    gradient that misses its bar passes if the kernel path moves it no
    further than the plain path's query embeddings moved by one ulp (the
    control, measured in the same run: the random model's first OPT layers
    are ill-conditioned; three draws) move the furthest-moved gradient
    (``compare_vlm_train_paths``); the count within the bar itself is
    printed.
  * conv eval (phase 10): fp32 folded against unfolded, max |logit
    difference| <= 1e-4 and equal argmax (the fp32 eval bar); bf16 against
    the fp32 model, max |d| <= 0.05 and <= 5% of the largest |logit|, and
    argmax agreement >= 0.98 over the samples whose fp32 top-2 margin is
    above the noise floor 2 max |d| (``bf16_vs_fp32`` says why it does not
    ask for half the samples above the floor). bf16 depthwise convolutions
    sum in whatever order cuDNN picks: nothing is held bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
SEED = 0
N_BATCHES, BATCH = 8, 128        # eval batch 128: config.MULTIMODAL_EVAL_BATCH
SEQ512_BATCH = 8                 # the paths driven at --seq_len=512


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def bf16_ulp(x):
    import torch

    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def max_err_ok(got, want, dtype, kind):
    """(max |d|, ok) under the tolerance of the module docstring."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs()
    if dtype == torch.float32:
        tol = (2e-5 + 2e-5 * w.abs()) if kind in ("rca", "block") else \
            (1e-5 + 1e-5 * w.abs())
    else:
        extra = {"rca": 1e-5, "block": 1e-2 * float(w.abs().max())}.get(
            kind, 1e-3)
        tol = bf16_ulp(torch.maximum(g.abs(), w.abs())) + extra
    finite = bool(torch.isfinite(g).all())
    return float(d.max()), finite and bool((d <= tol).all())


def time_ms(fn, reps: int = 20, warmup: int = 3, trials: int = 5):
    """Device time of one call: a CUDA graph of `reps` calls (no host
    launch gaps between them), replayed and timed with CUDA events,
    `trials` times. Returns (median, min, max) in ms per call."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out), min(out), max(out)


def time_ms_eager(fn, reps: int = 20, warmup: int = 3, trials: int = 5):
    """Device time of one call without a CUDA graph, for calls that seed a
    generator (a CUDA graph cannot capture that): CUDA events around
    `reps` eager calls, `trials` times; host launch gaps count. Returns
    (median, min, max) in ms per call."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out), min(out), max(out)


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------


def _rca_params(dtype, device, gen):
    import types

    import torch

    from garbage_classification_rca_tpu_torch.ops import attention as att

    p = types.SimpleNamespace(
        sa_txt=att.AttentionUnit(48, 48, 128, 96, generator=gen),
        sa_img=att.AttentionUnit(80, 80, 128, 96, generator=gen),
        rca_ti=att.AttentionUnit(96, 96, 64, 48, generator=gen),
        rca_it=att.AttentionUnit(96, 96, 64, 48, generator=gen))
    for name in ("sa_txt", "sa_img", "rca_ti", "rca_it"):
        u = getattr(p, name)
        with torch.no_grad():   # non-trivial LayerNorm affine
            u.norm.scale.uniform_(0.5, 1.5, generator=gen)
            u.norm.bias.uniform_(-0.5, 0.5, generator=gen)
        setattr(p, name, u.to(device=device, dtype=dtype))
    return p


RCA_FWD_STAGES = ("rca_fwd_self", "rca_fwd_cross")


def _rca_fwd_stage(name):
    """Which kernel of K1's staged route a profiler event is, or None."""
    return next((s for s in RCA_FWD_STAGES if s in name), None)


def _rca_fwd_bound(p, t, i):
    """(bound ms, side) of K1 on these inputs: 2,867,200 operations a
    sample (csrc note) at the fp32 rate; t, i and the weights read once,
    ti and it written once in t's dtype."""
    from garbage_classification_rca_tpu_torch.kernels import rca_fused as K

    b = t.shape[0]
    nbytes = (t.numel() * t.element_size() + i.numel() * i.element_size()
              + 2 * b * 16 * 48 * t.element_size()
              + K.N_WEIGHTS * p.sa_txt.q.w.element_size())
    ops = 2867200 * b / PEAK_FLOPS["float32"] * 1e3
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops, by_bytes), "operations" if ops >= by_bytes else "bytes"


def _rca_fwd_ab(p, t, i):
    """K1's two routes timed new-old-old-new on (t, i), reverse, beside the
    plain version, each staged kernel's time from the profiler, the bound
    and the share of it reached."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import rca_fused as K

    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    run = {r: functools.partial(K.rca_fused, p, t, i, reverse=True, route=r)
           for r in K.FWD_ROUTES}
    ab = {r: [] for r in K.FWD_ROUTES}
    for r in ("staged", "per_sample", "per_sample", "staged"):
        ab[r].append(time_ms(run[r])[0])
    plain_ms = time_ms(lambda: K.rca_fused_reference(p, t, i,
                                                     reverse=True))[0]
    parts = block_parts(run["staged"], RCA_FWD_STAGES,
                        part_of=_rca_fwd_stage)
    bound, side = _rca_fwd_bound(p, t, i)
    ms, old_ms = sum(ab["staged"]) / 2, sum(ab["per_sample"]) / 2
    return {"ms": ms, "ms_runs": ab["staged"], "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": side, "share_of_bound": bound / ms,
            "parts_ms": parts,
            "groups": K.rca_fwd_plan(t.shape[0], sms=sms).groups,
            "per_sample": {"ms": old_ms, "ms_runs": ab["per_sample"],
                           "share_of_bound": bound / old_ms}}


def check_rca(device, report):
    """K1 on its staged route (the default) against the plain version, and
    against its per-sample route (the first version) bit for bit: fp32 and
    bf16 at B = 128 (the eval batch), 13 and 1, reverse on and off; the
    training mix (t fp32, i bf16, fp32 weights) at B = 16 and once with
    bf16 weights. Both routes timed new-old-old-new at B = 128 bf16 and at
    B = 16 in the training mix."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import rca_fused as K

    gen = torch.Generator().manual_seed(SEED)
    ok_all, same_all, main = True, True, None

    def held(label, p, t, i, reverse, dtype):
        nonlocal ok_all, same_all
        got = K.rca_fused(p, t, i, reverse=reverse)
        old = K.rca_fused(p, t, i, reverse=reverse, route="per_sample")
        torch.cuda.synchronize()
        want = K.rca_fused_reference(p, t, i, reverse=reverse)
        errs = [max_err_ok(g, w, dtype, "rca") for g, w in zip(got, want)]
        old_ok = all(max_err_ok(g, w, dtype, "rca")[1]
                     for g, w in zip(old, want))
        diff = max(float((g.float() - o.float()).abs().max())
                   for g, o in zip(got, old))
        same = all(torch.equal(g, o) for g, o in zip(got, old))
        err = max(e for e, _ in errs)
        ok = (all(o for _, o in errs) and old_ok and same
              and got[0].dtype == t.dtype)
        ok_all &= ok
        same_all &= same
        print(f"  rca_fused {label} reverse={reverse!s:5s}: staged max|d|="
              f"{err:.3e}, per-sample within the bars {old_ok}; staged vs "
              f"per-sample max|d| {diff:.3e} (bit-identical {same}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        return err

    for dtype in (torch.float32, torch.bfloat16):
        p = _rca_params(dtype, device, gen)
        for b in (128, 13, 1):
            t = torch.randn((b, 16, 48), generator=gen).to(device, dtype)
            i = torch.randn((b, 16, 80), generator=gen).to(device, dtype)
            for reverse in (True, False):
                err = held(f"{str(dtype)[6:]:8s} B={b:3d}", p, t, i, reverse,
                           dtype)
                if dtype == torch.bfloat16 and b == 128 and reverse:
                    main = (p, t, i, err)
    # the training path's mixed input: t fp32 (text tower), i bf16 (image
    # tower), fp32 weights; outputs in t's dtype; then bf16 weights
    p32 = _rca_params(torch.float32, device, gen)
    t = torch.randn((16, 16, 48), generator=gen).to(device)
    i = torch.randn((16, 16, 80), generator=gen).to(device, torch.bfloat16)
    for reverse in (True, False):
        held("t float32 i bfloat16 B= 16", p32, t, i, reverse, torch.float32)
    held("bf16 weights, t float32 i bfloat16 B= 16",
         _rca_params(torch.bfloat16, device, gen), t, i, True, torch.float32)
    train = _rca_fwd_ab(p32, t, i)
    p, t, i, err = main
    ev = _rca_fwd_ab(p, t, i)
    report["rca_fused"] = {
        "name": "rca_fused", "route": "cuda",
        "source": "garbage_classification_rca_tpu_torch/csrc/rca_fused.cu",
        "replaces": "garbage_classification_rca_tpu/kernels/rca_fused.py:69",
        "max_abs_err": err, "library_ms": None, "fwd_route": "staged",
        **{k: ev[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "share_of_bound", "ms_runs", "parts_ms",
                              "groups", "per_sample")},
        "bit_identical_to_per_sample": same_all, "train_b16": train}
    for label, r in (("B=128 bf16", ev), ("B=16 t fp32 i bf16", train)):
        print(f"  rca_fused {label}, new-old-old-new: staged "
              f"{r['ms_runs'][0]:.4f} / {r['ms_runs'][1]:.4f} ms (G "
              f"{r['groups']}), per-sample {r['per_sample']['ms_runs'][0]:.4f}"
              f" / {r['per_sample']['ms_runs'][1]:.4f} ms; plain "
              f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), share staged {r['share_of_bound']:.4f}, "
              f"per-sample {r['per_sample']['share_of_bound']:.4f}; staged "
              f"parts: {_parts_line(r['parts_ms'])}", flush=True)
    return ok_all


def _mask(b, n, gen, device):
    import torch

    lens = torch.randint(1, n + 1, (b,), generator=gen)
    lens[0] = n
    m = (torch.arange(n)[None, :] < lens[:, None]).to(torch.int32)
    return m.to(device)


MHA_TC_NS = (1, 17, 64, 65, 197, 256)      # K2's tensor-core lengths
MHA_AB_SHAPES = ((128, 64, 768, True), (128, 197, 768, False))


def _k2_held(got, want, q, k, v, h, m, causal, edge):
    """(max |d|, ok, elements over one ulp + 1e-3) of K2's bf16 output:
    one ulp + 1e-3, and with `edge` (the tensor-core route, whose S is
    summed in another order) one ulp + the larger of 1e-3 and one weight's
    rounding move (``_one_flip_tol``)."""
    import torch

    err, ok = max_err_ok(got, want, q.dtype, "mha")
    g, w = got.float(), want.float()
    over = int(((g - w).abs() > bf16_ulp(torch.maximum(g.abs(), w.abs()))
                + 1e-3).sum()) if q.dtype == torch.bfloat16 else 0
    if edge and not ok:
        ok = bool(((g - w).abs() <= _one_flip_tol(q, k, v, h, m, causal,
                                                  got, want)).all())
    return err, ok, over


def check_mha(device, report):
    """K2 against its plain version on both routes: the CUDA cores (fp32,
    and bf16 forced by ``route``) at 128x64x768 masked, N = 512 and N =
    100 causal; the tensor cores (bf16, head dim 64, N <= 256) at those of
    the shapes it takes and at every N of MHA_TC_NS unmasked, key-masked
    with a fully masked sample and causal, bit-identical over two runs.
    Then the two routes timed in one call, new-old-old-new, at
    MHA_AB_SHAPES beside SDPA, the plain version and the bound. Rows
    ``mha`` (CUDA cores) and ``mha_tc``."""
    import torch
    import torch.nn.functional as F

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

    gen = torch.Generator().manual_seed(SEED + 1)
    ok_all = True
    main = None
    cases = [(128, 64, 768, 12, False), (8, 512, 768, 12, False),
             (16, 100, 768, 12, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, n, d, h, causal in cases:
            q, k, v = (torch.randn((b, n, d), generator=gen).to(device, dtype)
                       for _ in range(3))
            m = _mask(b, n, gen, device)
            want = K.mha_reference(q, k, v, heads=h, mask=m, causal=causal)
            routes = ["cuda_core"]
            if K.flash_plan(q.shape, h, dtype).route == "tc":
                routes.append("tc")
            for route in routes:
                got = K.mha(q, k, v, heads=h, mask=m, causal=causal,
                            route=route)
                torch.cuda.synchronize()
                err, ok, over = _k2_held(got, want, q, k, v, h, m, causal,
                                         edge=route == "tc")
                if route == "tc":
                    again = K.mha(q, k, v, heads=h, mask=m, causal=causal)
                    torch.cuda.synchronize()
                    ok &= torch.equal(got, again)
                ok_all &= ok
                print(f"  mha {route:9s} {str(dtype)[6:]:8s} B={b:3d} "
                      f"N={n:3d} D={d} H={h} causal={causal!s:5s}: "
                      f"max|d|={err:.3e}, elements over one ulp + 1e-3: "
                      f"{over} {'ok' if ok else 'FAIL'}", flush=True)
                if dtype == torch.bfloat16 and (b, n, causal) == (128, 64,
                                                                  False):
                    main = main or {}
                    main[route] = (err, over)
    for n in MHA_TC_NS:
        b, d, h = 4, 256, 4
        q, k, v = (torch.randn((b, n, d), generator=gen).to(
            device, torch.bfloat16) for _ in range(3))
        m = _mask(b, n, gen, device)
        m[-1] = 0
        for masked, causal in ((False, False), (True, False), (True, True),
                               (False, True)):
            mm = m if masked else None
            got = K.mha(q, k, v, heads=h, mask=mm, causal=causal)
            again = K.mha(q, k, v, heads=h, mask=mm, causal=causal)
            torch.cuda.synchronize()
            want = K.mha_reference(q, k, v, heads=h, mask=mm, causal=causal)
            err, ok, over = _k2_held(got, want, q, k, v, h, mm, causal, True)
            ok &= (torch.equal(got, again)
                   and K.flash_plan(q.shape, h, q.dtype).route == "tc")
            ok_all &= ok
            print(f"  mha tc bf16 B={b} N={n:3d} masked={masked!s:5s} "
                  f"causal={causal!s:5s}: max|d|={err:.3e}, over one ulp + "
                  f"1e-3: {over}; bit-identical over two runs "
                  f"{'ok' if ok else 'FAIL'}", flush=True)

    rows = {}
    for b, n, d, masked in MHA_AB_SHAPES:
        h = d // 64
        q, k, v = (torch.randn((b, n, d), generator=gen).to(
            device, torch.bfloat16) for _ in range(3))
        m = _mask(b, n, gen, device) if masked else None
        fn = {r: functools.partial(K.mha, q, k, v, heads=h, mask=m, route=r)
              for r in ("tc", "cuda_core")}
        ab = {"tc": [], "cuda_core": []}
        for route in ("tc", "cuda_core", "cuda_core", "tc"):
            ab[route].append(time_ms(fn[route])[0])
        plain = time_ms(lambda: K.mha_reference(q, k, v, heads=h, mask=m))[0]

        def sdpa():
            rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)
            o = F.scaled_dot_product_attention(
                rs(q), rs(k), rs(v),
                attn_mask=None if m is None else m.bool()[:, None, None, :])
            return o.transpose(1, 2).reshape(b, n, d)

        library = time_ms(sdpa)[0]
        flops = 4 * b * n * n * d                # QK^T and PV, every head
        nbytes = 4 * q.numel() * q.element_size() + (
            m.numel() * 4 if m is not None else 0)
        bound_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        bound = max(bound_ops, bound_bytes)
        err = {}
        for route in ("tc", "cuda_core"):
            got = fn[route]()
            torch.cuda.synchronize()
            err[route] = _k2_held(got, K.mha_reference(q, k, v, heads=h,
                                                       mask=m),
                                  q, k, v, h, m, False, route == "tc")
            ok_all &= err[route][1]
        for route in ("tc", "cuda_core"):
            t = sum(ab[route]) / 2
            rows.setdefault(route, []).append({
                "shape": [b, n, d], "masked": masked, "ms": t,
                "ms_runs": ab[route], "plain_ms": plain,
                "library_ms": library, "bound_ms": bound,
                "bound_by": "operations" if bound_ops >= bound_bytes
                else "bytes", "share_of_bound": bound / t,
                "max_abs_err": err[route][0],
                "over_one_ulp_1e-3": err[route][2]})
        print(f"  mha bf16 {b}x{n}x{d} masked={masked}, new-old-old-new: tc "
              f"{ab['tc'][0]:.4f} / {ab['tc'][1]:.4f} ms, CUDA cores "
              f"{ab['cuda_core'][0]:.4f} / {ab['cuda_core'][1]:.4f} ms; "
              f"plain {plain:.4f} ms, sdpa {library:.4f} ms, bound "
              f"{bound:.4f} ms; share of the bound: tc "
              f"{bound / (sum(ab['tc']) / 2):.3f}; max|d| tc "
              f"{err['tc'][0]:.3e} ({err['tc'][2]} elements over one ulp + "
              f"1e-3), CUDA cores {err['cuda_core'][0]:.3e}", flush=True)
    for name, route in (("mha", "cuda_core"), ("mha_tc", "tc")):
        first, *others = rows[route]
        report[name] = {
            "name": name, "route": "cuda",
            "source": "garbage_classification_rca_tpu_torch/csrc/mha_fused.cu",
            "replaces": "garbage_classification_rca_tpu/kernels/mha_fused.py:91",
            **{key: first[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape", "share_of_bound", "ms_runs",
                "over_one_ulp_1e-3")},
            "other_shapes": others}
    report["mha"]["checks_at_main_shape"] = main
    return ok_all


def grad_err_ok(got, want, dtype):
    """(max |d|, ok) for a gradient: |d| <= 5e-5 (1 + |x|) in fp32 (the
    JAX package's backward bar), and one ulp of the value + 2e-3 of the
    tensor's largest |x| in bf16 (a product input rounded to the
    neighbouring bf16 value moves the sum by about its ulp)."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs()
    if dtype == torch.float32:
        tol = 5e-5 * (1.0 + w.abs())
    else:
        tol = bf16_ulp(torch.maximum(g.abs(), w.abs())) \
            + 2e-3 * float(w.abs().max())
    finite = bool(torch.isfinite(g).all())
    return float(d.max()), finite and bool((d <= tol).all())


def rca_bwd_flops(b):
    """Operations of the block's backward with its forward recomputed, per
    the csrc note: 8,601,600 per sample."""
    return 8601600 * b


RCA_BWD_BATCHES = (16, 13, 1, 64)       # the train microbatch, ragged, edges
RCA_BWD_STAGES = ("rca_bwd_self_fwd", "rca_bwd_cross", "rca_bwd_self_bwd",
                  "rca_bwd_wgrad")


def _rca_bwd_stage(name):
    """Which kernel of K3's staged route a profiler event is, or None."""
    return next((s for s in RCA_BWD_STAGES if s in name), None)


def _rca_bwd_pairs(got, want, t_dtype, i_dtype):
    """(got, want, dtype) of dt, di and the 32 weight gradients."""
    import torch

    return ([(got[0], want[0], t_dtype), (got[1], want[1], i_dtype)]
            + [(a, c, torch.float32) for a, c in zip(got[2], want[2])])


def check_rca_bwd(device, report):
    """K3 against the autograd of the plain version: its staged route (the
    default) at B = 16 (the train microbatch), 13, 1 and 64, (t fp32, i
    bf16) as training gives them and all fp32, reverse on and off, and
    once with bf16 weights; the
    per-sample route (its first version) on the same inputs, held to the
    plain version too and to the staged route bit for bit (the same fp32
    chains: max|d| printed for dt, di and the weight gradients); both
    timed new-old-old-new at B = 16 (t fp32, i bf16, reverse), each
    staged kernel's time from the profiler."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import rca_fused as K

    gen = torch.Generator().manual_seed(SEED + 6)
    p = _rca_params(torch.float32, device, gen)
    ok_all, main, same_all = True, None, True
    for i_dtype in (torch.bfloat16, torch.float32):
        for b in RCA_BWD_BATCHES:
            t = torch.randn((b, 16, 48), generator=gen).to(device)
            i = torch.randn((b, 16, 80), generator=gen).to(device, i_dtype)
            g = [torch.randn((b, 16, 48), generator=gen).to(device)
                 for _ in range(2)]
            for reverse in (True, False):
                got = K.rca_fused_bwd(p, t, i, *g, reverse=reverse)
                old = K.rca_fused_bwd(p, t, i, *g, reverse=reverse,
                                      route="per_sample")
                torch.cuda.synchronize()
                want = K.rca_fused_bwd_reference(p, t, i, *g,
                                                 reverse=reverse)
                errs = [grad_err_ok(a, c, dt) for a, c, dt in
                        _rca_bwd_pairs(got, want, t.dtype, i_dtype)]
                old_ok = all(grad_err_ok(a, c, dt)[1] for a, c, dt in
                             _rca_bwd_pairs(old, want, t.dtype, i_dtype))
                diffs = [float((a.float() - c.float()).abs().max())
                         for a, c, _ in _rca_bwd_pairs(got, old, t.dtype,
                                                       i_dtype)]
                same = all(torch.equal(a, c) for a, c, _ in
                           _rca_bwd_pairs(got, old, t.dtype, i_dtype))
                err = max(e for e, _ in errs)
                ok = all(o for _, o in errs) and old_ok and same
                ok_all &= ok
                same_all &= same
                print(f"  rca_fused_bwd i={str(i_dtype)[6:]:8s} B={b:3d} "
                      f"reverse={reverse!s:5s}: staged max|d|={err:.3e}, "
                      f"per-sample within the bars {old_ok}; staged vs "
                      f"per-sample max|d| dt {diffs[0]:.3e} di "
                      f"{diffs[1]:.3e} weights {max(diffs[2:]):.3e} "
                      f"(bit-identical {same}) {'ok' if ok else 'FAIL'}",
                      flush=True)
                if i_dtype == torch.bfloat16 and b == 16 and reverse:
                    main = (t, i, g, err)
    t, i, g, err = main
    # bf16 weights (the staging that converts on the way to shared memory)
    p16 = _rca_params(torch.bfloat16, device, gen)
    got = K.rca_fused_bwd(p16, t, i, *g, reverse=True)
    old = K.rca_fused_bwd(p16, t, i, *g, reverse=True, route="per_sample")
    want = K.rca_fused_bwd_reference(p16, t, i, *g, reverse=True)
    errs = [grad_err_ok(a, c, dt) for a, c, dt in
            _rca_bwd_pairs(got, want, t.dtype, i.dtype)]
    same = all(torch.equal(a, c) for a, c, _ in
               _rca_bwd_pairs(got, old, t.dtype, i.dtype))
    ok = all(o for _, o in errs) and same
    ok_all &= ok
    same_all &= same
    print(f"  rca_fused_bwd bf16 weights, i=bfloat16 B= 16 reverse=True : "
          f"staged max|d|={max(e for e, _ in errs):.3e}, bit-identical to "
          f"per-sample {same} {'ok' if ok else 'FAIL'}", flush=True)
    run = {r: functools.partial(K.rca_fused_bwd, p, t, i, *g, reverse=True,
                                route=r) for r in K.BWD_ROUTES}
    ab = {r: [] for r in K.BWD_ROUTES}
    for r in ("staged", "per_sample", "per_sample", "staged"):
        ab[r].append(time_ms(run[r])[0])
    plain_ms, p_lo, p_hi = time_ms(
        lambda: K.rca_fused_bwd_reference(p, t, i, *g, reverse=True))
    parts = block_parts(run["staged"], RCA_BWD_STAGES, part_of=_rca_bwd_stage)
    b = t.shape[0]
    nbytes = (t.numel() * 4 * 2 + i.numel() * i.element_size() * 2
              + sum(a.numel() * 4 for a in g) + 2 * K.N_WEIGHTS * 4)
    bound_ops = rca_bwd_flops(b) / PEAK_FLOPS["float32"] * 1e3
    bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound = max(bound_ops, bound_bytes)
    ms = sum(ab["staged"]) / 2
    old_ms = sum(ab["per_sample"]) / 2
    report["rca_fused_bwd"] = {
        "name": "rca_fused_bwd", "route": "cuda",
        "source": "garbage_classification_rca_tpu_torch/csrc/rca_fused.cu",
        "replaces": "garbage_classification_rca_tpu/kernels/rca_fused.py:219",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": None, "bwd_route": "staged",
        "share_of_bound": bound / ms,
        "ms_runs": ab["staged"], "parts_ms": parts,
        "bit_identical_to_per_sample": same_all,
        "per_sample": {"ms": old_ms, "ms_runs": ab["per_sample"],
                       "share_of_bound": bound / old_ms}}
    print(f"  rca_fused_bwd B=16 t fp32 i bf16, new-old-old-new: staged "
          f"{ab['staged'][0]:.4f} / {ab['staged'][1]:.4f} ms, per-sample "
          f"{ab['per_sample'][0]:.4f} / {ab['per_sample'][1]:.4f} ms; plain "
          f"{plain_ms:.4f} [{p_lo:.4f}, {p_hi:.4f}] ms; bound {bound:.5f} ms "
          f"({report['rca_fused_bwd']['bound_by']}), share staged "
          f"{bound / ms:.4f}, per-sample {bound / old_ms:.4f}; staged "
          f"parts: {_parts_line(parts)}", flush=True)
    return ok_all


def _efficient_attention(q, k, v, bias, h):
    """The library's memory-efficient attention on [B, N, D] tensors:
    (out and lse in its own layout, the rest of its outputs)."""
    import torch

    b, n, d = q.shape
    rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)
    return torch.ops.aten._scaled_dot_product_efficient_attention(
        rs(q), rs(k), rs(v), bias, True)


def _forward_ab(launch, plans):
    """Device times of a forward under its 3xTF32 plan and its CUDA-core
    plan, new-old-old-new: {route: [ms, ms]}."""
    ab = {"tc32": [], "cuda_core": []}
    for r in ("tc32", "cuda_core", "cuda_core", "tc32"):
        ab[r].append(time_ms(functools.partial(launch, plans[r]))[0])
    return ab


def _fwd_row(name, ms, plain, lib_ms, flops, nbytes, err, line, flop_peak,
             **extra):
    """A forward's report row: its bound from this run's shapes, the share
    of the bound reached."""
    bound_ops = flops / PEAK_FLOPS[flop_peak] * 1e3
    bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound = max(bound_ops, bound_bytes)
    return {"name": name, "route": "cuda",
            "source": "garbage_classification_rca_tpu_torch/csrc/mha_fused.cu",
            "replaces": f"garbage_classification_rca_tpu/kernels/mha_fused.py:"
                        f"{line}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound,
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": lib_ms, "share_of_bound": bound / ms, **extra}


def _check_fwd_routes(name, run, plain, shape, h, dtype, dropout, label):
    """The forward `run(route)` (None: the wrapper's own route) against
    `plain` (out, lse) on every route that takes the shape, each run twice:
    ({route: max error}, all ok)."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

    default = K.flash_plan(shape, h, dtype, dropout=dropout).route
    routes = {default, "cuda_core"}
    try:
        K.flash_plan(shape, h, dtype, route="tc32", dropout=dropout)
        routes.add("tc32")
    except ValueError:
        pass
    errs, ok_all = {}, True
    for route in sorted(routes):
        got, again = (run(None if route == default else route)
                      for _ in range(2))
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        torch.cuda.synchronize()
        e_o, ok_o = max_err_ok(got[0], plain[0], dtype, "mha")
        e_l, ok_l = max_err_ok(got[1], plain[1], torch.float32, "mha")
        ok = ok_o and ok_l and same
        ok_all &= ok
        errs[route] = max(e_o, e_l)
        print(f"  {name} ({route}{', default' if route == default else ''})"
              f" {label}: out max|d|={e_o:.3e} lse {e_l:.3e}, bit-identical "
              f"over two runs {same} {'ok' if ok else 'FAIL'}", flush=True)
    return errs, ok_all


def check_mha_train(device, report):
    """K4a and K4b against their plain versions: (16, 64, 768, 12 heads),
    the DistilBERT training shape, and N=512, fp32 (the training dtype)
    and bf16, random key lengths, and a causal case; in fp32 at N = 64 K4a
    on the CUDA cores (its default) and on the 3xTF32 route (on request),
    timed new-old-old-new at 16x64x768 and 128x64x768 (the text trainer's
    shape without ``--hf_internal_dropout``)."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

    gen = torch.Generator().manual_seed(SEED + 7)
    ok_all, main = True, {}
    cases = [(16, 64, 768, 12, False), (4, 512, 768, 12, False),
             (6, 100, 768, 12, True), (128, 64, 768, 12, False)]
    # the forward-only 128x64x768 case draws from a generator of its own,
    # so that the other cases (and check_mha_tc, which continues `gen`)
    # keep their inputs
    gen_big = torch.Generator().manual_seed(SEED + 17)
    for dtype in (torch.float32, torch.bfloat16):
        for b, n, d, h, causal in cases:
            if b == 128 and dtype != torch.float32:
                continue
            g = gen_big if b == 128 else gen
            q, k, v, do = (torch.randn((b, n, d), generator=g).to(device,
                                                                dtype)
                           for _ in range(4))
            m = _mask(b, n, g, device)
            o_w, lse_w = K.mha_fwd_lse_reference(q, k, v, heads=h, mask=m,
                                                 causal=causal)
            kw = dict(heads=h, mask=m, causal=causal)
            e_f, ok_f = _check_fwd_routes(
                "mha_fwd_lse", lambda r: K.mha_fwd_lse(q, k, v, **kw)
                if r is None else K.launch_fwd_lse(
                    K.flash_plan(q.shape, h, dtype, route=r), q, k, v, **kw),
                (o_w, lse_w), q.shape, h, dtype, False,
                f"{str(dtype)[6:]:8s} B={b:3d} N={n:3d} causal={causal!s:5s}")
            ok_all &= ok_f
            o, lse = K.mha_fwd_lse(q, k, v, **kw)
            if dtype == torch.float32 and b == 128:
                main["big"] = dict(q=q, k=k, v=v, m=m, e_f=e_f)
                continue
            want = K.mha_flash_bwd_reference(q, k, v, o, do, lse, heads=h,
                                             mask=m, causal=causal)
            plan = K.flash_plan(q.shape, h, dtype)
            for bwd in sorted({plan.bwd_route, "cuda_core"}):
                grads = K.launch_flash_bwd(
                    K.flash_plan(q.shape, h, dtype, bwd_route=bwd), q, k, v,
                    o, do, lse, heads=h, mask=m, causal=causal)
                again = K.mha_flash_bwd(q, k, v, o, do, lse, heads=h,
                                        mask=m, causal=causal) \
                    if bwd == plan.bwd_route else grads
                torch.cuda.synchronize()
                errs = [grad_err_ok(a, c, dtype) for a, c in zip(grads,
                                                                  want)]
                e_b = max(e for e, _ in errs)
                same = all(torch.equal(x, y) for x, y in zip(grads, again))
                ok = same and all(o_ for _, o_ in errs)
                ok_all &= ok
                print(f"  mha_flash_bwd ({bwd}) {str(dtype)[6:]:8s} "
                      f"B={b:3d} N={n:3d} causal={causal!s:5s}: max|d|="
                      f"{e_b:.3e}, bit-identical over two runs {same} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if dtype == torch.float32 and (b, n) == (16, 64):
                    if "q" not in main:
                        main.update(q=q, k=k, v=v, do=do, m=m, h=h, o=o,
                                    lse=lse, e_f=e_f, e_b={})
                    main["e_b"][bwd] = e_b
    q, k, v, do, m, h = (main[x] for x in ("q", "k", "v", "do", "m", "h"))
    o, lse = main["o"], main["lse"]
    b, n, d = q.shape
    # K4a, new-old-old-new, at 16x64x768 (the MM-RCA trainer) and
    # 128x64x768 (the text trainer without --hf_internal_dropout)
    fwd = {}
    for tag, x in (("16x64x768", main), ("128x64x768", main["big"])):
        xq, xk, xv, xm = (x[y] for y in ("q", "k", "v", "m"))
        xb = xq.shape[0]
        plans = {r: K.flash_plan(xq.shape, h, xq.dtype, route=r)
                 for r in ("tc32", "cuda_core")}
        ab = _forward_ab(lambda p: K.launch_fwd_lse(p, xq, xk, xv, heads=h,
                                                    mask=xm), plans)
        bias = ((xm.float() - 1.0) * 1e30)[:, None, None, :].expand(
            xb, h, n, n).contiguous()
        fwd[tag] = dict(
            ab=ab, plain=time_ms(lambda: K.mha_fwd_lse_reference(
                xq, xk, xv, heads=h, mask=xm))[0],
            lib=time_ms(lambda: _efficient_attention(xq, xk, xv, bias,
                                                     h))[0],
            flops=4 * xb * n * n * d,
            bytes=4 * xq.numel() * 4 + xm.numel() * 4 + xb * h * n * 4,
            e_f=x["e_f"])
        del bias
    for route, name, peak, passes in (("cuda_core", "mha_fwd_lse", "float32",
                                       1),
                                      ("tc32", "mha_fwd_lse_tc32", "tf32", 3)):
        rows = {tag: _fwd_row(name, sum(f["ab"][route]) / 2, f["plain"],
                              f["lib"], passes * f["flops"], f["bytes"],
                              f["e_f"][route], 274, peak,
                              ms_runs=f["ab"][route])
                for tag, f in fwd.items()}
        report[name] = {**rows["16x64x768"],
                        "at_128x64x768": rows["128x64x768"]}
    # K4a keeps the CUDA cores on its main paths: the 3xTF32 forward's
    # readings go with that row
    report["mha_fwd_lse"]["tc32_on_request"] = report.pop("mha_fwd_lse_tc32")
    for tag, f in fwd.items():
        old = report["mha_fwd_lse"]
        new = old["tc32_on_request"]
        if tag != "16x64x768":
            new, old = new["at_" + tag], old["at_" + tag]
        print(f"  mha_fwd_lse fp32 {tag}, new-old-old-new: 3xTF32 "
              f"{f['ab']['tc32'][0]:.4f} / {f['ab']['tc32'][1]:.4f} ms, CUDA "
              f"cores {f['ab']['cuda_core'][0]:.4f} / "
              f"{f['ab']['cuda_core'][1]:.4f} ms; plain {f['plain']:.4f} ms, "
              f"efficient attention {f['lib']:.4f} ms, bound "
              f"{new['bound_ms']:.5f} ms ({new['bound_by']}): share of the "
              f"bound 3xTF32 {new['share_of_bound']:.3f}, CUDA cores "
              f"{old['share_of_bound']:.3f}", flush=True)
    bwd = {r: functools.partial(
        K.launch_flash_bwd, K.flash_plan(q.shape, h, q.dtype, bwd_route=r),
        q, k, v, o, do, lse, heads=h, mask=m) for r in ("tc32", "cuda_core")}
    ab_b = {"tc32": [], "cuda_core": []}
    for r in ("tc32", "cuda_core", "cuda_core", "tc32"):
        ab_b[r].append(time_ms(bwd[r])[0])
    ms_b = sum(ab_b["cuda_core"]) / 2
    plain_b = time_ms(lambda: K.mha_flash_bwd_reference(
        q, k, v, o, do, lse, heads=h, mask=m))[0]
    bias = ((m.float() - 1.0) * 1e30)[:, None, None, :].expand(
        b, h, n, n).contiguous()
    lib = _efficient_attention(q, k, v, bias, h)
    rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)
    lib_b = time_ms(lambda: torch.ops.aten.
                    _scaled_dot_product_efficient_attention_backward(
                        rs(do), rs(q), rs(k), rs(v), bias, lib[0], lib[1],
                        lib[2], lib[3], 0.0, [True, True, True, False]))[0]
    item = q.element_size()
    flops_b = 10 * b * n * n * d      # S, dP, dV, dQ, dK
    bytes_b = 8 * q.numel() * item + m.numel() * 4 + b * h * n * 4
    for name, ms, plain, lib_ms, flops, nbytes, err, line, flop_peak in (
            ("mha_flash_bwd", ms_b, plain_b, lib_b, flops_b, bytes_b,
             main["e_b"]["cuda_core"], 317, "float32"),
            ("mha_flash_bwd_tc32", sum(ab_b["tc32"]) / 2, plain_b, lib_b,
             3 * flops_b, bytes_b, main["e_b"]["tc32"], 317, "tf32")):
        bound_ops = flops / PEAK_FLOPS[flop_peak] * 1e3
        bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        report[name] = {
            "name": name, "route": "cuda",
            "source": "garbage_classification_rca_tpu_torch/csrc/mha_fused.cu",
            "replaces": f"garbage_classification_rca_tpu/kernels/mha_fused.py:"
                        f"{line}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": lib_ms}
    report["mha_flash_bwd_tc32"]["ms_runs"] = ab_b["tc32"]
    report["mha_flash_bwd"]["ms_runs"] = ab_b["cuda_core"]
    print(f"  mha_flash_bwd B=16 N=64 D=768 fp32, new-old-old-new: 3xTF32 "
          f"{ab_b['tc32'][0]:.4f} / {ab_b['tc32'][1]:.4f} ms, CUDA cores "
          f"{ab_b['cuda_core'][0]:.4f} / {ab_b['cuda_core'][1]:.4f} ms; "
          f"plain {plain_b:.4f} ms, efficient attention backward "
          f"{lib_b:.4f} ms, bound "
          f"{report['mha_flash_bwd_tc32']['bound_ms']:.4f} ms "
          f"({report['mha_flash_bwd_tc32']['bound_by']})", flush=True)
    ok_all &= check_mha_tc(device, report, gen)
    return ok_all


TC_EDGE_NS = (1, 17, 63, 64, 65, 128, 197, 256)   # the tc route's lengths
TC_AB_SHAPES = ((128, 197, 768), (128, 64, 768))  # ViT-B/16 train; B x 64


def _flash_pair(plan, q, k, v, do, h, m=None, causal=False):
    """(out, lse, (dq, dk, dv)) of the flash pair launched under `plan`."""
    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

    o, lse = K.launch_fwd_lse(plan, q, k, v, heads=h, mask=m, causal=causal)
    grads = K.launch_flash_bwd(plan, q, k, v, o, do, lse, heads=h, mask=m,
                               causal=causal)
    return o, lse, grads


def _held_to_plain(q, k, v, do, h, m, causal, o, lse, grads, edge=False):
    """(max |d| forward, max |d| backward, ok) of the pair's outputs
    against the plain pair on the same inputs (the backward from the
    kernel's own out and lse), under the bf16 limits of the module
    docstring. With `edge` (the tensor-core route's edge cases): a row
    whose largest softmax weight w is large (a causal row with few keys)
    holds the output to one ulp + ulp(w) max|v| instead of 1e-3, and at
    N = 1 dQ / dK are held to their exact value, zero (``_single_key``)."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

    o_w, lse_w = K.mha_fwd_lse_reference(q, k, v, heads=h, mask=m,
                                         causal=causal)
    e_o, ok_o = max_err_ok(o, o_w, q.dtype, "mha")
    e_l, ok_l = max_err_ok(lse, lse_w, lse.dtype, "mha")
    if edge and not ok_o:
        ok_o = bool(((o.float() - o_w.float()).abs()
                     <= _one_flip_tol(q, k, v, h, m, causal, o, o_w)).all())
    want = K.mha_flash_bwd_reference(q, k, v, o, do, lse, heads=h, mask=m,
                                     causal=causal)
    errs = [grad_err_ok(a, c, q.dtype) for a, c in zip(grads, want)]
    if edge and q.shape[1] == 1:
        errs[:2] = _single_key(q, k, v, do, h, grads)
    return (max(e_o, e_l), max(e for e, _ in errs),
            ok_o and ok_l and all(x for _, x in errs))


def _one_flip_tol(q, k, v, h, m, causal, o, o_w):
    """One bf16 ulp of the output + the larger of 1e-3 and the move of one
    softmax weight to its neighbouring bf16 value: ulp(w) |v| for the
    row's largest weight w and the head's largest |v|. The kernel sums S
    on the tensor cores in another order than the plain version, so a
    weight near a bf16 rounding boundary may round the other way; where
    the weights are small that move is under 1e-3."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

    b, n, d = q.shape
    s = K._scores(q, k, h, 1.0 / (d // h) ** 0.5, m, causal)
    # [B, H, N]; a weight of 1 is exact: the largest that can round
    # the other way lies below 1
    w_max = torch.softmax(s, dim=-1).amax(-1).clamp(max=1 - 2.0 ** -9)
    v_max = K._heads(v, h).abs().amax(dim=(2, 3))             # [B, H]
    flip = bf16_ulp(w_max) * v_max[:, :, None]
    flip = flip.transpose(1, 2).repeat_interleave(d // h, dim=2)
    return bf16_ulp(torch.maximum(o.float().abs(), o_w.float().abs())) + \
        torch.clamp(flip, min=1e-3)


def _single_key(q, k, v, do, h, grads):
    """[(max |dq|, ok), (max |dk|, ok)] at N = 1, where dS = W (dP - Delta)
    with W = 1 and O = V is zero in exact arithmetic: what the kernel and
    the plain version give is the rounding of the two fp32 dot products
    dP = dO . v and Delta = dO . O, each within dh 2^-23 sum |dO v| (up to
    one fp32 ulp per addition), times |k| (dQ) or |q| (dK) and the
    scale."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

    b, n, d = q.shape
    dh = d // h
    dots = (K._heads(do, h) * K._heads(v, h)).abs().sum(-1, keepdim=True)
    ds = 2 * dh * 2.0 ** -23 * dots                           # [B, H, 1, 1]
    out = []
    for g, x in zip(grads[:2], (k, q)):
        tol = K._merge(ds * K._heads(x, h).abs() / dh ** 0.5, torch.float32)
        out.append((float(g.float().abs().max()),
                    bool((g.float().abs() <= tol).all())))
    return out


def check_mha_tc(device, report, gen):
    """The tensor-core route of K4a / K4b (``flash_plan`` "tc": bf16, head
    dim 64, N <= 256) against the plain pair: every N of TC_EDGE_NS
    unmasked, key-masked (the last sample fully masked) and causal; the
    ViT-B/16 train shape (128 x 197 x 768) with its gradients bit-identical
    over two runs. Then, at each TC_AB_SHAPES shape, the two routes timed
    in one call in the order new-old-old-new, beside the plain pair, the
    library's efficient attention (forward + lse, and its backward) and
    the bound. Rows ``mha_fwd_lse_tc`` / ``mha_flash_bwd_tc``; the old
    kernels' times at these shapes under ``ab`` of ``mha_fwd_lse`` /
    ``mha_flash_bwd``."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

    ok_all, dtype = True, torch.bfloat16
    for n in TC_EDGE_NS:
        b, d, h = 4, 256, 4
        q, k, v, do = (torch.randn((b, n, d), generator=gen).to(device, dtype)
                       for _ in range(4))
        m = _mask(b, n, gen, device)
        m[-1] = 0
        plan = K.flash_plan(q.shape, h, dtype)
        for masked, causal in ((False, False), (True, False), (True, True),
                               (False, True)):
            mm = m if masked else None
            out = _flash_pair(plan, q, k, v, do, h, mm, causal)
            torch.cuda.synchronize()
            e_f, e_b, ok = _held_to_plain(q, k, v, do, h, mm, causal, *out,
                                          edge=True)
            ok &= plan.route == "tc" and all(
                bool(torch.isfinite(g).all()) for g in out[2])
            ok_all &= ok
            print(f"  tc route bf16 B={b} N={n:3d} (np {plan.np:3d}) "
                  f"masked={masked!s:5s} causal={causal!s:5s}: fwd max|d|="
                  f"{e_f:.3e} bwd {e_b:.3e} {'ok' if ok else 'FAIL'}",
                  flush=True)

    rows = {}
    for b, n, d in TC_AB_SHAPES:
        h = d // 64
        q, k, v, do = (torch.randn((b, n, d), generator=gen).to(device, dtype)
                       for _ in range(4))
        tc = K.flash_plan(q.shape, h, dtype)
        old = K.flash_plan(q.shape, h, dtype, route="cuda_core")
        o, lse, grads = _flash_pair(tc, q, k, v, do, h)
        again = _flash_pair(tc, q, k, v, do, h)[2]
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        e_f, e_b, ok = _held_to_plain(q, k, v, do, h, None, False, o, lse,
                                      grads)
        ok &= same and tc.route == "tc"
        ok_all &= ok
        print(f"  tc route bf16 {b}x{n}x{d}: fwd max|d|={e_f:.3e} bwd "
              f"{e_b:.3e}; gradients bit-identical over two runs: {same} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        o_old, lse_old = K.launch_fwd_lse(old, q, k, v, heads=h)
        f = {"tc": lambda: K.launch_fwd_lse(tc, q, k, v, heads=h),
             "cuda_core": lambda: K.launch_fwd_lse(old, q, k, v, heads=h)}
        g = {"tc": lambda: K.launch_flash_bwd(tc, q, k, v, o, do, lse,
                                              heads=h),
             "cuda_core": lambda: K.launch_flash_bwd(old, q, k, v, o_old, do,
                                                     lse_old, heads=h)}
        ab = {"fwd": {"tc": [], "cuda_core": []},
              "bwd": {"tc": [], "cuda_core": []}}
        for route in ("tc", "cuda_core", "cuda_core", "tc"):
            ab["fwd"][route].append(time_ms(f[route], reps=5)[0])
            ab["bwd"][route].append(time_ms(g[route], reps=5)[0])
        plain_f = time_ms(lambda: K.mha_fwd_lse_reference(q, k, v, heads=h),
                          reps=5)[0]
        plain_b = time_ms(lambda: K.mha_flash_bwd_reference(
            q, k, v, o, do, lse, heads=h), reps=5)[0]
        lib = _efficient_attention(q, k, v, None, h)
        lib_f = time_ms(lambda: _efficient_attention(q, k, v, None, h),
                        reps=5)[0]
        rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)
        lib_b = time_ms(lambda: torch.ops.aten.
                        _scaled_dot_product_efficient_attention_backward(
                            rs(do), rs(q), rs(k), rs(v), None, lib[0],
                            lib[1], lib[2], lib[3], 0.0,
                            [True, True, True, False]), reps=5)[0]
        del lib
        item = q.element_size()
        for name, key, plain, lib_ms, flops, nbytes, err, line in (
                ("mha_fwd_lse", "fwd", plain_f, lib_f, 4 * b * n * n * d,
                 4 * q.numel() * item + b * h * n * 4, e_f, 274),
                ("mha_flash_bwd", "bwd", plain_b, lib_b, 10 * b * n * n * d,
                 8 * q.numel() * item + b * h * n * 4, e_b, 317)):
            bound_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
            bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            bound = max(bound_ops, bound_bytes)
            t_new = sum(ab[key]["tc"]) / 2        # mean of the two runs
            t_old = sum(ab[key]["cuda_core"]) / 2
            row = {"shape": [b, n, d], "heads": h, "dtype": "bfloat16",
                   "np": tc.np, "max_abs_err": err, "ms": t_new,
                   "ms_runs": ab[key]["tc"], "old_ms": t_old,
                   "old_ms_runs": ab[key]["cuda_core"], "plain_ms": plain,
                   "library_ms": lib_ms, "bound_ms": bound,
                   "bound_by": "operations" if bound_ops >= bound_bytes
                   else "bytes", "share_of_bound": bound / t_new,
                   "old_share_of_bound": bound / t_old,
                   "line": line}
            rows.setdefault(name, []).append(row)
            print(f"  {name} bf16 {b}x{n}x{d} unmasked, new-old-old-new: "
                  f"tc {ab[key]['tc'][0]:.4f} / {ab[key]['tc'][1]:.4f} ms, "
                  f"CUDA cores {ab[key]['cuda_core'][0]:.4f} / "
                  f"{ab[key]['cuda_core'][1]:.4f} ms; plain {plain:.4f} ms, "
                  f"efficient attention {lib_ms:.4f} ms, bound {bound:.4f} "
                  f"ms ({row['bound_by']}); share of the bound: tc "
                  f"{bound / t_new:.3f}, CUDA cores {bound / t_old:.3f}",
                  flush=True)
        del o, lse, grads, again, o_old, lse_old
        torch.cuda.empty_cache()
    for name, (main, *others) in rows.items():
        report[name]["ab"] = rows[name]
        report[f"{name}_tc"] = {
            "name": f"{name}_tc", "route": "cuda",
            "source": "garbage_classification_rca_tpu_torch/csrc/mha_fused.cu",
            "replaces": f"garbage_classification_rca_tpu/kernels/mha_fused.py:"
                        f"{main['line']}",
            **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "shape", "np", "share_of_bound",
                                    "old_ms")},
            "other_shapes": [{k: r[k] for k in (
                "shape", "ms", "old_ms", "plain_ms", "library_ms",
                "bound_ms", "share_of_bound")} for r in others]}
    return ok_all


def check_mha_drop(device, report):
    """K7a and K7b against their plain versions on the same keep mask: the
    text trainer's shape (fp32 [128, 64, 768], 12 heads, p 0.1, random key
    lengths), bf16, causal, unmasked, N = 197 and N = 50 (odd rows of mask
    bytes), N = 512, p = 0.5; every masked case with a fully masked sample
    and every case with a fully dropped row. The mask is drawn twice from
    the key and must come out the same, bit for bit. Times: the kernels on
    a mask drawn before (CUDA graph) and with the draw (eager), the plain
    versions, and the library's efficient attention with dropout_p (it
    draws its own mask inside: a yardstick of time, never an oracle). In
    fp32 at N <= 64 K7a runs on its 3xTF32 route and, beside it, on the
    CUDA cores; the two are timed new-old-old-new, as the backward's are."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K
    from garbage_classification_rca_tpu_torch.nn.core import Key

    gen = torch.Generator().manual_seed(SEED + 60)
    ok_all, main = True, None
    cases = [(128, 64, 768, 12, True, False, 0.1),
             (16, 64, 768, 12, True, True, 0.1),
             (8, 197, 768, 12, False, False, 0.1),
             (8, 50, 768, 12, True, False, 0.1),
             (4, 512, 768, 12, True, False, 0.1),
             (16, 64, 768, 12, True, False, 0.5),
             (4, 197, 1024, 16, False, False, 0.1)]
    for dtype in (torch.float32, torch.bfloat16):
        for ci, (b, n, d, h, masked, causal, p) in enumerate(cases):
            q, k, v, do = (torch.randn((b, n, d), generator=gen).to(device,
                                                                  dtype)
                           for _ in range(4))
            m = None
            if masked:
                m = _mask(b, n, gen, device)
                m[-1] = 0                     # every key of this sample
            key = Key(SEED + 61 + ci)
            dm = K.drop_keep_mask(key, p, b, h, n, device)
            same = torch.equal(dm, K.drop_keep_mask(key, p, b, h, n, device))
            dm[0, 0, 1] = 0                   # a fully dropped row
            kw = dict(heads=h, keep=1.0 - p, mask=m, causal=causal)
            o_w, lse_w = K.mha_fwd_lse_drop_reference(q, k, v, dm, **kw)
            e_f, ok_f = _check_fwd_routes(
                "mha_fwd_lse_drop", lambda r: K.mha_fwd_lse_drop(
                    q, k, v, dm, **kw) if r is None else K.launch_fwd_lse_drop(
                    K.flash_plan(q.shape, h, dtype, route=r, dropout=True), q,
                    k, v, dm, **kw), (o_w, lse_w), q.shape, h, dtype, True,
                f"{str(dtype)[6:]:8s} B={b:3d} N={n:3d} D={d} p={p} "
                f"mask={masked!s:5s} causal={causal!s:5s}")
            o, lse = K.mha_fwd_lse_drop(q, k, v, dm, **kw)
            torch.cuda.synchronize()
            want = K.mha_flash_bwd_drop_reference(q, k, v, o, do, lse, dm,
                                                  **kw)
            zero_row = bool((o[0, 1, :d // h] == 0).all())
            plan = K.flash_plan(q.shape, h, dtype, dropout=True)
            for bwd in sorted({plan.bwd_route, "cuda_core"}):
                grads = K.launch_flash_bwd_drop(
                    K.flash_plan(q.shape, h, dtype, bwd_route=bwd,
                                 dropout=True),
                    q, k, v, o, do, lse, dm, **kw)
                again = K.mha_flash_bwd_drop(q, k, v, o, do, lse, dm, **kw) \
                    if bwd == plan.bwd_route else grads
                torch.cuda.synchronize()
                errs = [grad_err_ok(a, c, dtype) for a, c in zip(grads,
                                                                  want)]
                e_b = max(e for e, _ in errs)
                bits = all(torch.equal(x, y) for x, y in zip(grads, again))
                ok = (same and ok_f and zero_row and bits
                      and all(o_ for _, o_ in errs))
                ok_all &= ok
                print(f"  mha_flash_bwd_drop ({bwd}) {str(dtype)[6:]:8s} "
                      f"B={b:3d} N={n:3d} D={d} p={p} mask={masked!s:5s} "
                      f"causal={causal!s:5s}: max|d|={e_b:.3e}, redraw "
                      f"equal={same}, a dropped row's output zero "
                      f"{zero_row}, bit-identical over two runs {bits} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if dtype == torch.float32 and ci == 0:
                    main = main or dict(q=q, k=k, v=v, do=do, m=m, h=h, o=o,
                                        lse=lse, dm=dm, key=key, p=p,
                                        e_f=e_f, e_b={})
                    main["e_b"][bwd] = e_b
            del o_w, lse_w, want
    q, k, v, do, m, h, o, lse, dm, key, p = (main[x] for x in (
        "q", "k", "v", "do", "m", "h", "o", "lse", "dm", "key", "p"))
    b, n, d = q.shape
    kw = dict(heads=h, keep=1.0 - p, mask=m)
    # each route for both kernels: the forward's A/B, then the backward's
    plans = {r: K.flash_plan(q.shape, h, q.dtype, route=r, dropout=True)
             for r in ("tc32", "cuda_core")}
    ab_f = _forward_ab(lambda pl: K.launch_fwd_lse_drop(pl, q, k, v, dm,
                                                        **kw), plans)
    ab_b = {"tc32": [], "cuda_core": []}
    for r in ("tc32", "cuda_core", "cuda_core", "tc32"):
        ab_b[r].append(time_ms(functools.partial(
            K.launch_flash_bwd_drop, plans[r], q, k, v, o, do, lse, dm,
            **kw))[0])
    plain_f = time_ms(lambda: K.mha_fwd_lse_drop_reference(q, k, v, dm,
                                                           **kw))[0]
    plain_b = time_ms(lambda: K.mha_flash_bwd_drop_reference(
        q, k, v, o, do, lse, dm, **kw))[0]
    draw = time_ms_eager(lambda: K.drop_keep_mask(key, p, b, h, n, device))[0]
    with_draw_f = {r: time_ms_eager(lambda: K.launch_fwd_lse_drop(
        plans[r], q, k, v, K.drop_keep_mask(key, p, b, h, n, device),
        **kw))[0] for r in ("tc32", "cuda_core")}
    with_draw_b = {r: time_ms_eager(lambda: K.launch_flash_bwd_drop(
        plans[r], q, k, v, o, do, lse,
        K.drop_keep_mask(key, p, b, h, n, device), **kw))[0]
        for r in ("tc32", "cuda_core")}
    bias = ((m.float() - 1.0) * 1e30)[:, None, None, :].expand(
        b, h, n, n).contiguous()
    rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)
    lib_call = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        rs(q), rs(k), rs(v), bias, True, p)
    lib = lib_call()
    lib_f = time_ms_eager(lib_call)[0]
    lib_b = time_ms_eager(
        lambda: torch.ops.aten.
        _scaled_dot_product_efficient_attention_backward(
            rs(do), rs(q), rs(k), rs(v), bias, lib[0], lib[1], lib[2],
            lib[3], p, [True, True, True, False]))[0]
    item = q.element_size()
    small = m.numel() * 4 + b * h * n * 4            # key mask and lse
    bytes_b = 8 * q.numel() * item + dm.numel() + small
    bytes_f = 4 * q.numel() * item + dm.numel() + small
    rows = (("mha_fwd_lse_drop", sum(ab_f["cuda_core"]) / 2, plain_f, lib_f,
             with_draw_f["cuda_core"], 4 * b * n * n * d, bytes_f,
             main["e_f"]["cuda_core"], 560, "float32"),
            ("mha_fwd_lse_drop_tc32", sum(ab_f["tc32"]) / 2, plain_f, lib_f,
             with_draw_f["tc32"], 3 * 4 * b * n * n * d, bytes_f,
             main["e_f"]["tc32"], 560, "tf32"),
            ("mha_flash_bwd_drop", sum(ab_b["cuda_core"]) / 2, plain_b,
             lib_b, with_draw_b["cuda_core"], 10 * b * n * n * d, bytes_b,
             main["e_b"]["cuda_core"], 610, "float32"),
            ("mha_flash_bwd_drop_tc32", sum(ab_b["tc32"]) / 2, plain_b,
             lib_b, with_draw_b["tc32"], 3 * 10 * b * n * n * d, bytes_b,
             main["e_b"]["tc32"], 610, "tf32"))
    for name, ms, plain, lib_ms, with_draw, flops, nbytes, err, line, \
            flop_peak in rows:
        bound_ops = flops / PEAK_FLOPS[flop_peak] * 1e3
        bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        report[name] = {
            "name": name, "route": "cuda",
            "source": "garbage_classification_rca_tpu_torch/csrc/mha_fused.cu",
            "replaces": f"garbage_classification_rca_tpu/kernels/mha_fused.py:"
                        f"{line}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": lib_ms,
            "library_is": "efficient attention with dropout_p (draws its own "
                          "mask inside), eager",
            "ms_with_mask_draw_eager": with_draw, "mask_draw_ms_eager": draw,
            "bytes": nbytes, "gflops": flops / 1e9,
            "share_of_bound": max(bound_ops, bound_bytes) / ms}
    report["mha_fwd_lse_drop_tc32"]["ms_runs"] = ab_f["tc32"]
    report["mha_fwd_lse_drop"]["ms_runs"] = ab_f["cuda_core"]
    new, old = report["mha_fwd_lse_drop_tc32"], report["mha_fwd_lse_drop"]
    print(f"  mha_fwd_lse_drop B={b} N={n} D={d} fp32 p={p}, new-old-old-new: "
          f"3xTF32 {ab_f['tc32'][0]:.4f} / {ab_f['tc32'][1]:.4f} ms, CUDA "
          f"cores {ab_f['cuda_core'][0]:.4f} / {ab_f['cuda_core'][1]:.4f} ms; "
          f"with the mask draw (eager) {with_draw_f['tc32']:.4f} / "
          f"{with_draw_f['cuda_core']:.4f} ms (the draw alone {draw:.4f} "
          f"ms), plain {plain_f:.4f} ms, efficient attention with dropout "
          f"(eager) {lib_f:.4f} ms, bound {new['bound_ms']:.4f} ms "
          f"({new['bound_by']}): share of the bound 3xTF32 "
          f"{new['share_of_bound']:.3f}, CUDA cores "
          f"{old['share_of_bound']:.3f}", flush=True)
    report["mha_flash_bwd_drop_tc32"]["ms_runs"] = ab_b["tc32"]
    report["mha_flash_bwd_drop"]["ms_runs"] = ab_b["cuda_core"]
    print(f"  mha_flash_bwd_drop same shape, new-old-old-new: 3xTF32 "
          f"{ab_b['tc32'][0]:.4f} / {ab_b['tc32'][1]:.4f} ms, CUDA cores "
          f"{ab_b['cuda_core'][0]:.4f} / {ab_b['cuda_core'][1]:.4f} ms; with "
          f"the mask draw (eager) {with_draw_b['tc32']:.4f} / "
          f"{with_draw_b['cuda_core']:.4f} ms, plain {plain_b:.4f} ms, "
          f"efficient attention backward with dropout (eager) {lib_b:.4f} "
          f"ms, bound {report['mha_flash_bwd_drop_tc32']['bound_ms']:.4f} ms "
          f"({report['mha_flash_bwd_drop_tc32']['bound_by']}); CUDA-core "
          f"bound {report['mha_flash_bwd_drop']['bound_ms']:.4f} ms",
          flush=True)
    return ok_all


def _block_weights(d, ffn, dtype, device, gen):
    """Input-major weights in `dtype`, fp32 biases and LN parameters (what
    a layer's ``packed()`` hands the wrappers)."""
    import torch

    w = lambda i, o: (torch.randn((i, o), generator=gen) * i ** -0.5).to(
        device, dtype)
    vec = lambda k: (torch.randn((k,), generator=gen) * 0.1).to(device)
    ls = (1.0 + torch.randn((d,), generator=gen) * 0.1).to(device)
    return dict(ls=ls, lb=vec(d), wqkv=w(d, 3 * d), bqkv=vec(3 * d),
                wout=w(d, d), bout=vec(d), w1=w(d, ffn), b1=vec(ffn),
                w2=w(ffn, d), b2=vec(d))


def _library_attn(x, mask, p, heads, eps, post):
    """The unfused chain of library calls for an attention block (no single
    PyTorch call computes one): F.linear + scaled_dot_product_attention +
    F.linear + F.layer_norm, weights in F.linear's [out, in] layout."""
    import torch.nn.functional as F

    b, n, d = x.shape
    h = x if post else F.layer_norm(x, (d,), p["ls_t"], p["lb_t"], eps)
    q, k, v = F.linear(h, p["wqkv_oi"], p["bqkv_t"]).chunk(3, dim=-1)
    rs = lambda a: a.reshape(b, n, heads, d // heads).transpose(1, 2)
    am = None if mask is None else mask.bool()[:, None, None, :]
    a = F.scaled_dot_product_attention(rs(q), rs(k), rs(v), attn_mask=am)
    y = x + F.linear(a.transpose(1, 2).reshape(b, n, d), p["wout_oi"],
                     p["bout_t"])
    return F.layer_norm(y, (d,), p["ls_t"], p["lb_t"], eps) if post else y


def _library_mlp(x, p, eps, post):
    import torch.nn.functional as F

    d = x.shape[-1]
    h = x if post else F.layer_norm(x, (d,), p["ls_t"], p["lb_t"], eps)
    y = x + F.linear(F.gelu(F.linear(h, p["w1_oi"], p["b1_t"])), p["w2_oi"],
                     p["b2_t"])
    return F.layer_norm(y, (d,), p["ls_t"], p["lb_t"], eps) if post else y


def block_parts(fn, parts, reps=5, part_of=None):
    """Device ms per call of each kernel of a bf16 block, by
    ``_block_part``'s name (or `part_of`'s), for the names in `parts`:
    torch.profiler over `reps` eager calls of `fn`, which runs that block
    alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k in parts}
    for e in prof.key_averages():
        part = (part_of or _block_part)(e.key)
        if e.device_type != DeviceType.CUDA or part not in out:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[part] += us / 1e3 / reps
    return out


def mlp_parts(fn, reps=5):
    """Device ms per call of each kernel of a bf16 MLP block (GEMM1, GEMM2,
    the LayerNorm pass)."""
    p = block_parts(fn, ("gemm1", "residual", "ln"), reps)
    return {"gemm1": p["gemm1"], "gemm2": p["residual"], "ln": p["ln"]}


def attn_parts(fn, reps=5):
    """Device ms per call of each kernel of a bf16 attention block on the
    tensor cores: the LayerNorm pass (pre-norm before the QKV GEMM,
    post-norm after the out GEMM), the QKV GEMM, the per-head core, the
    out-projection GEMM."""
    p = block_parts(fn, ("ln", "qkv", "core", "residual"), reps)
    return {"ln": p["ln"], "qkv_gemm": p["qkv"], "core": p["core"],
            "out_gemm": p["residual"]}


def _parts_line(parts):
    return ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + " ms"


def _check_blocks(device, report, *, post, main, odd, seed, wide=None):
    """The two fused blocks of one family (post-norm: K5a / K5b; pre-norm:
    K6a / K6b) against their plain versions: fp32 (TF32 off) and bf16, at
    the main path's shape `main` and the odd one `odd` (both (B, N, D,
    heads, FFN)); post-norm with random key lengths and, at the odd shape, a
    fully masked row; the MLP with gelu and, at the odd shape, relu. Then
    the times at the main shape in bf16: kernel, plain version, and the
    unfused chain of library calls; the split of each block into its
    kernels and the share of the bound. The bf16 attention block runs on
    the tensor cores; its CUDA-core body (``route="cuda_cores"``) is held
    to the same plain version at both shapes and timed beside it in one
    call, new-old-old-new. `wide`: one more bf16 shape for both blocks
    (the MLP with gelu and relu), checked and timed the same way."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import (
        transformer_block as K)

    gen = torch.Generator().manual_seed(seed)
    eps = 1e-12 if post else 1e-6
    a_name, m_name = (("postnorm_attn_block", "postnorm_mlp_block") if post
                      else ("attn_block", "mlp_block"))
    lines = {"postnorm_attn_block": 346, "postnorm_mlp_block": 361,
             "attn_block": 88, "mlp_block": 127}

    def attn(fn, x, mask, p, heads, **route):
        if post:
            return fn(x, mask, p["wqkv"], p["bqkv"], p["wout"], p["bout"],
                      p["ls"], p["lb"], heads=heads, eps=eps, **route)
        return fn(x, p["ls"], p["lb"], p["wqkv"], p["bqkv"], p["wout"],
                  p["bout"], heads=heads, eps=eps, **route)

    def mlp(fn, x, p, act="gelu"):
        if post:
            return fn(x, p["w1"], p["b1"], p["w2"], p["b2"], p["ls"],
                      p["lb"], eps=eps, act=act)
        return fn(x, p["ls"], p["lb"], p["w1"], p["b1"], p["w2"], p["b2"],
                  eps=eps, act=act)

    a_ref = getattr(K, a_name + "_reference")
    m_ref = getattr(K, m_name + "_reference")
    ok_all, kept = True, None
    for dtype in (torch.float32, torch.bfloat16):
        for shape in (main, odd):
            b, n, d, heads, ffn = shape
            p = _block_weights(d, ffn, dtype, device, gen)
            x = torch.randn((b, n, d), generator=gen).to(device, dtype)
            mask = None
            if post:
                mask = _mask(b, n, gen, device)
                if shape == odd:
                    mask[-1] = 0          # every key of this sample masked
            before = dict(getattr(K, a_name).route_launches)
            cases = [(a_name, attn(getattr(K, a_name), x, mask, p, heads),
                      lambda: attn(a_ref, x, mask, p, heads)),
                     (m_name, mlp(getattr(K, m_name), x, p),
                      lambda: mlp(m_ref, x, p))]
            route = ("tensor_cores" if dtype == torch.bfloat16
                     else "cuda_cores")
            routed = getattr(K, a_name).route_launches == {
                **before, route: before[route] + 1}
            ok_all &= routed
            if dtype == torch.bfloat16:
                cases.append((a_name + " cuda_cores",
                              attn(getattr(K, a_name), x, mask, p, heads,
                                   route="cuda_cores"),
                              lambda: attn(a_ref, x, mask, p, heads)))
            if shape == odd:
                cases.append((m_name + " relu",
                              mlp(getattr(K, m_name), x, p, "relu"),
                              lambda: mlp(m_ref, x, p, "relu")))
            torch.cuda.synchronize()
            errs = {}
            for name, got, plain in cases:
                err, ok = max_err_ok(got, plain(), dtype, "block")
                ok_all &= ok
                errs[name] = err
                where = (f" ({route}, counted {routed})" if name == a_name
                         else "")
                print(f"  {name:24s} {str(dtype)[6:]:8s} B={b:3d} N={n:3d} "
                      f"D={d} H={heads} FFN={ffn}{where}: max|d|={err:.3e} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
            if dtype == torch.bfloat16 and shape == main:
                kept = (x, mask, p, heads, errs)
    x, mask, p, heads, errs = kept
    b, n, d = x.shape
    ffn = p["w1"].shape[1]
    for k in ("wqkv", "wout", "w1", "w2"):
        p[k + "_oi"] = p[k].t().contiguous()
    for k in ("ls", "lb", "bqkv", "bout", "b1", "b2"):
        p[k + "_t"] = p[k].to(x.dtype)
    item = x.element_size()
    tokens = b * n
    rows = (
        (a_name, lambda: attn(getattr(K, a_name), x, mask, p, heads),
         lambda: attn(a_ref, x, mask, p, heads),
         lambda: _library_attn(x, mask, p, heads, eps, post),
         tokens * (2 * (d * 3 * d + d * d) + 4 * n * d),
         2 * x.numel() * item + 4 * d * d * item + 6 * d * 4
         + (mask.numel() * 4 if post else 0)),
        (m_name, lambda: mlp(getattr(K, m_name), x, p),
         lambda: mlp(m_ref, x, p),
         lambda: _library_mlp(x, p, eps, post),
         tokens * 4 * d * ffn,
         2 * x.numel() * item + 2 * d * ffn * item + (3 * d + ffn) * 4))
    for name, kern, plain, lib, flops, nbytes in rows:
        if name == a_name:
            # the two routes in one call, new-old-old-new
            old = lambda: attn(getattr(K, a_name), x, mask, p, heads,
                               route="cuda_cores")
            ab = {"tensor_cores": [], "cuda_cores": []}
            for r in ("tensor_cores", "cuda_cores", "cuda_cores",
                      "tensor_cores"):
                ab[r].append(time_ms(kern if r == "tensor_cores" else old,
                                     reps=5)[0])
            ms = sum(ab["tensor_cores"]) / 2
            lo, hi = min(ab["tensor_cores"]), max(ab["tensor_cores"])
        else:
            ms, lo, hi = time_ms(kern, reps=5)
        plain_ms = time_ms(plain, reps=5)[0]
        lib_ms = time_ms(lib, reps=5)[0]
        bound_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        bound = max(bound_ops, bound_bytes)
        report[name] = {
            "name": name, "route": "cuda",
            "source": "garbage_classification_rca_tpu_torch/csrc/"
                      "transformer_block.cu",
            "replaces": "garbage_classification_rca_tpu/kernels/"
                        f"transformer_block.py:{lines[name]}",
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": lib_ms,
            "library_is": "unfused chain: F.linear + scaled_dot_product_"
                          "attention + F.layer_norm" if "attn" in name else
                          "unfused chain: F.linear + F.gelu + F.layer_norm",
            "plan_route": "tensor_cores", "shape": [b, n, d],
            "gflops": flops / 1e9, "tflops_per_s": flops / ms / 1e9,
            "bound_share": bound / ms, "chain_ratio": ms / lib_ms}
        print(f"  {name} B={b} N={n} D={d} FFN={ffn} bf16 (tensor cores; "
              f"{'mean of 2 A/B turns' if name == a_name else 'median of 5'}"
              f" [min, max]): kernel {ms:.4f} [{lo:.4f}, {hi:.4f}] ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s, {bound / ms:.1%} of the "
              f"bound, {ms / lib_ms:.2f}x the chain), plain {plain_ms:.4f} "
              f"ms, library chain {lib_ms:.4f} ms, bound {bound:.4f} ms "
              f"({report[name]['bound_by']})", flush=True)
        if name == a_name:
            parts = attn_parts(kern)
            report[name]["parts_ms"] = parts
            report[name]["cuda_cores"] = {
                "ms_runs": ab["cuda_cores"],
                "ms": sum(ab["cuda_cores"]) / 2,
                "max_abs_err": errs[a_name + " cuda_cores"]}
            report[name]["ms_runs"] = ab["tensor_cores"]
            print(f"    {name} new-old-old-new: tensor cores "
                  f"{ab['tensor_cores'][0]:.4f} / {ab['tensor_cores'][1]:.4f}"
                  f" ms, CUDA cores {ab['cuda_cores'][0]:.4f} / "
                  f"{ab['cuda_cores'][1]:.4f} ms; kernels (profiler, mean of "
                  f"5 calls): {_parts_line(parts)}", flush=True)
        if name == m_name:
            parts = mlp_parts(kern)
            relu = mlp_parts(lambda: mlp(getattr(K, m_name), x, p, "relu"))
            report[name]["parts_ms"] = parts
            report[name]["gemm1_relu_ms"] = relu["gemm1"]
            print(f"    {name} kernels (profiler, mean of 5 calls): GEMM1 "
                  f"{parts['gemm1']:.4f} ms (with ReLU instead of GELU "
                  f"{relu['gemm1']:.4f}), GEMM2 {parts['gemm2']:.4f} ms, "
                  f"LayerNorm pass {parts['ln']:.4f} ms", flush=True)
            report[name]["tile_widths"] = _tile_width_ab(
                K, kern, b * n, d, ffn, post, device)
    if wide is not None:
        ok_all &= _check_wide_mlp(device, report, m_name, mlp, m_ref, wide,
                                  eps, post, gen)
        ok_all &= _check_wide_attn(device, report, a_name, attn, a_ref, wide,
                                   eps, post, gen)
    return ok_all


def _tile_width_ab(K, kern, rows, d, ffn, post, device):
    """Each GEMM of a bf16 MLP block whose launch plan picks a tile narrower
    than 256, timed at the planned width and at 256 (the plan's widths
    patched to 256 alone), in the order planned, 256, 256, planned:
    GEMM -> {width: [ms, ms]} (profiler, mean of 5 calls each)."""
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = K.mlp_plan(rows, d, ffn, torch.bfloat16, post, sms)
    narrow = {g: bn for g, (bn, _) in zip(("gemm1", "gemm2"), plan.gemms)
              if bn != 256}
    out = {g: {bn: [], 256: []} for g, bn in narrow.items()}
    if not narrow:
        return out
    saved = K.TC_BNS
    for wide in (False, True, True, False):
        K.TC_BNS = (256,) if wide else saved
        try:
            parts = mlp_parts(kern)
        finally:
            K.TC_BNS = saved
        for g, bn in narrow.items():
            out[g][256 if wide else bn].append(parts[g])
    for g, times in out.items():
        print(f"    {g} tile width (planned first): " + ", ".join(
            f"{w}: {' / '.join(f'{t:.4f}' for t in ts)} ms"
            for w, ts in times.items()), flush=True)
    return {g: {str(w): ts for w, ts in times.items()}
            for g, times in out.items()}


def _check_wide_mlp(device, report, m_name, mlp, m_ref, shape, eps, post,
                    gen):
    """The bf16 MLP block alone at `shape` (ViT-L/16's full eval width):
    kernel against plain version (gelu, relu), then kernel / plain /
    library-chain times, its kernels' split and the share of the bound."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import (
        transformer_block as K)

    b, n, d, heads, ffn = shape
    p = _block_weights(d, ffn, torch.bfloat16, device, gen)
    x = torch.randn((b, n, d), generator=gen).to(device, torch.bfloat16)
    ok, out = True, {"shape": [b, n, d, ffn]}
    for act in ("gelu", "relu"):
        got = mlp(getattr(K, m_name), x, p, act)
        err, good = max_err_ok(got, mlp(m_ref, x, p, act), torch.bfloat16,
                               "block")
        ok &= good
        out[f"max_abs_err_{act}"] = err
        print(f"  {m_name + ' ' + act:24s} bfloat16 B={b:3d} N={n:3d} D={d} "
              f"FFN={ffn}: max|d|={err:.3e} {'ok' if good else 'FAIL'}",
              flush=True)
    p["w1_oi"], p["w2_oi"] = p["w1"].t().contiguous(), p["w2"].t().contiguous()
    for k in ("ls", "lb", "b1", "b2"):
        p[k + "_t"] = p[k].to(x.dtype)
    kern = lambda: mlp(getattr(K, m_name), x, p)
    ms = time_ms(kern, reps=5)[0]
    flops = 4 * b * n * d * ffn
    nbytes = 2 * x.numel() * 2 + 2 * d * ffn * 2 + (3 * d + ffn) * 4
    bound = max(flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES_PER_S) * 1e3
    out.update(ms=ms, plain_ms=time_ms(lambda: mlp(m_ref, x, p), reps=5)[0],
               library_ms=time_ms(lambda: _library_mlp(x, p, eps, post),
                                  reps=5)[0],
               bound_ms=bound, tflops_per_s=flops / ms / 1e9,
               bound_share=bound / ms, parts_ms=mlp_parts(kern))
    report[m_name + "_wide"] = out
    print(f"  {m_name} B={b} N={n} D={d} FFN={ffn} bf16: kernel {ms:.4f} ms "
          f"({out['tflops_per_s']:.2f} TFLOP/s, {bound / ms:.1%} of the "
          f"bound), plain {out['plain_ms']:.4f} ms, library chain "
          f"{out['library_ms']:.4f} ms, bound {bound:.4f} ms (operations); "
          f"GEMM1 {out['parts_ms']['gemm1']:.4f} ms, GEMM2 "
          f"{out['parts_ms']['gemm2']:.4f} ms, LayerNorm pass "
          f"{out['parts_ms']['ln']:.4f} ms", flush=True)
    return ok


def _check_wide_attn(device, report, a_name, attn, a_ref, shape, eps, post,
                     gen):
    """The bf16 attention block alone at `shape` (ViT-L/16's full eval
    width) on the tensor cores: against its plain version, then kernel /
    plain / library-chain times, its kernels' split and the share of the
    bound."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import (
        transformer_block as K)

    b, n, d, heads, ffn = shape
    p = _block_weights(d, ffn, torch.bfloat16, device, gen)
    x = torch.randn((b, n, d), generator=gen).to(device, torch.bfloat16)
    mask = _mask(b, n, gen, device) if post else None
    before = dict(getattr(K, a_name).route_launches)
    got = attn(getattr(K, a_name), x, mask, p, heads)
    err, ok = max_err_ok(got, attn(a_ref, x, mask, p, heads), torch.bfloat16,
                         "block")
    ok &= getattr(K, a_name).route_launches["tensor_cores"] == \
        before["tensor_cores"] + 1
    print(f"  {a_name:24s} bfloat16 B={b:3d} N={n:3d} D={d} H={heads} "
          f"(tensor_cores): max|d|={err:.3e} {'ok' if ok else 'FAIL'}",
          flush=True)
    p["wqkv_oi"], p["wout_oi"] = (p["wqkv"].t().contiguous(),
                                  p["wout"].t().contiguous())
    for k in ("ls", "lb", "bqkv", "bout"):
        p[k + "_t"] = p[k].to(x.dtype)
    kern = lambda: attn(getattr(K, a_name), x, mask, p, heads)
    ms = time_ms(kern, reps=5)[0]
    flops = b * n * (2 * 4 * d * d + 4 * n * d)
    nbytes = 2 * x.numel() * 2 + 4 * d * d * 2 + 6 * d * 4 + (
        mask.numel() * 4 if post else 0)
    bound = max(flops / PEAK_FLOPS["bfloat16"],
                nbytes / PEAK_BYTES_PER_S) * 1e3
    out = {"shape": [b, n, d], "heads": heads, "max_abs_err": err, "ms": ms,
           "plain_ms": time_ms(lambda: attn(a_ref, x, mask, p, heads),
                               reps=5)[0],
           "library_ms": time_ms(lambda: _library_attn(x, mask, p, heads, eps,
                                                       post), reps=5)[0],
           "bound_ms": bound, "tflops_per_s": flops / ms / 1e9,
           "bound_share": bound / ms, "parts_ms": attn_parts(kern)}
    out["chain_ratio"] = ms / out["library_ms"]
    report[a_name + "_wide"] = out
    print(f"  {a_name} B={b} N={n} D={d} H={heads} bf16 (tensor cores): "
          f"kernel {ms:.4f} ms ({out['tflops_per_s']:.2f} TFLOP/s, "
          f"{bound / ms:.1%} of the bound, {out['chain_ratio']:.2f}x the "
          f"chain), plain {out['plain_ms']:.4f} ms, library chain "
          f"{out['library_ms']:.4f} ms, bound {bound:.4f} ms (operations); "
          f"{_parts_line(out['parts_ms'])}", flush=True)
    return ok


def check_postnorm_blocks(device, report):
    """K5a / K5b at the BERT-family eval shape (256 x 64 x 768, 12 heads,
    FFN 3072) and at N = 17 with a batch of 3."""
    return _check_blocks(device, report, post=True,
                         main=(256, 64, 768, 12, 3072),
                         odd=(3, 17, 768, 12, 3072), seed=SEED + 20)


def check_prenorm_blocks(device, report):
    """K6a / K6b at the ViT-B/16 eval shape (64 x 197 x 768, 12 heads, FFN
    3072) and at N = 17 with ViT-L/16's widths (1024, 16 heads, 4096); K6b
    in bf16 at ViT-L/16's full eval width (64 x 197 x 1024, FFN 4096)."""
    return _check_blocks(device, report, post=False,
                         main=(64, 197, 768, 12, 3072),
                         odd=(3, 17, 1024, 16, 4096), seed=SEED + 21,
                         wide=(64, 197, 1024, 16, 4096))


# ---------------------------------------------------------------------------
# phase 4: the model
# ---------------------------------------------------------------------------


class SyntheticBatcher:
    """ImageTextBatcher stand-in: seeded uint8 480x480 images and
    WordPiece-tokenized random texts, fixed-shape batches, all made before
    the run so that the measured loop holds no data generation."""

    def __init__(self, n, batch_size, image_size, tokenizer, seq_len, seed):
        import numpy as np

        rng = np.random.default_rng(seed)
        words = [w for w in tokenizer.vocab
                 if w.isalpha() and not w.startswith("[")]
        self.m = list(range(n))
        self.batches = []
        h, w = image_size
        for start in range(0, n, batch_size):
            k = min(batch_size, n - start)
            texts = [" ".join(rng.choice(words, rng.integers(2, 40)))
                     for _ in range(k)] + [""] * (batch_size - k)
            enc = tokenizer.encode_batch(texts, seq_len)
            label = rng.integers(0, 4, batch_size).astype(np.int32)
            self.batches.append({
                "image": rng.integers(0, 256, (batch_size, h, w, 3),
                                      dtype=np.uint8),
                "input_ids": enc.input_ids,
                "attention_mask": enc.attention_mask,
                "label": label,
                "valid": (np.arange(batch_size) < k).astype(np.int32)})

    def iter_batches(self, batch_size, *, shuffle=False, **_):
        assert batch_size == len(self.batches[0]["label"]) and not shuffle
        yield from self.batches


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel call sites to the plain versions (eval and
    train; the plain versions are differentiable by autograd)."""
    from garbage_classification_rca_tpu_torch.kernels import mha_fused
    from garbage_classification_rca_tpu_torch.kernels import rca_fused
    from garbage_classification_rca_tpu_torch.kernels import (
        transformer_block as tb)
    from garbage_classification_rca_tpu_torch.models.fusion import multimodal
    from garbage_classification_rca_tpu_torch.models.image import vit
    from garbage_classification_rca_tpu_torch.models.text import encoder_common
    from garbage_classification_rca_tpu_torch.models.vlm import blip2_vision
    from garbage_classification_rca_tpu_torch.models.vlm import opt as vlm_opt

    def plain_dropout(q, k, v, *, heads, key, p, scale=0.0, mask=None,
                      causal=False):
        b, n, _ = q.shape
        dm = mha_fused.drop_keep_mask(key, p, b, heads, n, q.device)
        return mha_fused.mha_fwd_lse_drop_reference(
            q, k, v, dm, heads=heads, keep=1.0 - p, scale=scale, mask=mask,
            causal=causal)[0]

    sites = ((tb, "postnorm_attn_block", tb.postnorm_attn_block_reference),
             (tb, "postnorm_mlp_block", tb.postnorm_mlp_block_reference),
             (tb, "attn_block", tb.attn_block_reference),
             (tb, "mlp_block", tb.mlp_block_reference),
             (vit, "mha", mha_fused.mha_reference),
             (vit, "mha_flash_train", mha_fused.mha_reference),
             (encoder_common, "mha_flash_train_dropout", plain_dropout),
             (encoder_common, "mha", mha_fused.mha_reference),
             (encoder_common, "mha_flash_train", mha_fused.mha_reference),
             (blip2_vision, "mha", mha_fused.mha_reference),
             (vlm_opt, "mha", mha_fused.mha_reference),
             (vlm_opt, "mha_flash_train", mha_fused.mha_reference),
             (multimodal, "rca_fused", rca_fused.rca_fused_reference),
             (multimodal, "rca_fused_trainable",
              rca_fused.rca_fused_reference))
    saved = [getattr(mod, name) for mod, name, _ in sites]
    for mod, name, plain in sites:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(sites, saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def flash_routes(fwd=None, bwd=None):
    """Every flash plan made inside without a route asked for, of a shape
    the 3xTF32 routes take, takes the forward route `fwd` and the backward
    route `bwd` ("tc32" or "cuda_core"; None keeps a side's default): the
    sides of phase 8's A/B of the text trainer's step."""
    from garbage_classification_rca_tpu_torch.kernels import mha_fused

    plan = mha_fused.flash_plan

    def forced(shape, heads, dtype, route=None, *, bwd_route=None,
               dropout=False):
        p = plan(shape, heads, dtype, route, bwd_route=bwd_route,
                 dropout=dropout)
        if route is None and bwd_route is None and p.bwd_route == "tc32":
            p = plan(shape, heads, dtype, fwd or p.route,
                     bwd_route=bwd or p.bwd_route, dropout=dropout)
        return p

    mha_fused.flash_plan = forced
    try:
        yield
    finally:
        mha_fused.flash_plan = plan


def _randomize_bn(model, gen):
    import torch

    from garbage_classification_rca_tpu_torch.nn.core import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.scale.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)
                m.mean.normal_(0.0, 0.2, generator=gen)
                m.var.uniform_(0.5, 2.0, generator=gen)


def _logits(model, batch, dtype, device):
    import torch

    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)

    with torch.inference_mode():
        x = normalize_on_device(torch.from_numpy(batch["image"]).to(device),
                                dtype=dtype)
        ids = torch.from_numpy(batch["input_ids"]).to(device)
        mask = torch.from_numpy(batch["attention_mask"]).to(device)
        return model(ids, mask, x).float()


def _block_part(name: str):
    """Which kernel of a bf16 block on the tensor cores a profiler event is:
    "ln" (LayerNorm rows), "gemm1" (the MLP's hidden GEMM), "qkv" (the
    attention's QKV GEMM), "residual" (the attention's out-projection or
    the MLP's second GEMM: one epilogue), "core" (the ftc forward without
    lse, which K2 runs too) or None."""
    n = name.lower()
    if "ln_rows_kernel" in name:
        return "ln"
    if "gemm_kernel" in name and "HiddenEpi" in name:
        return "gemm1"
    if "gemm_kernel" in name and "QkvEpi" in name:
        return "qkv"
    if "gemm_kernel" in name and "ResidualEpi" in name:
        return "residual"
    if "ftc::" in n and "fwd_kernel" in n and "false>" in n:
        return "core"
    return None


def _wide_lse(n: str) -> bool:
    """Whether a profiler name of ``ftc::wide_kernel<DH, MASKED, CAUSAL,
    LSE>`` is the instance with lse (K4a)."""
    import re

    f = re.search(r"wide_kernel<\d+, *\w+, *\w+, *(\w+)>", n)
    return bool(f) and f[1] in ("true", "1")


def _wide_bwd(n: str) -> bool:
    """Whether a profiler name is one of K4b's tensor-core kernels at head
    dim 80 (``ftc::dq_wide_kernel`` / ``dkdv_wide_kernel``)."""
    return "dq_wide_kernel" in n or "dkdv_wide_kernel" in n


def _kind(name: str) -> str:
    n = name.lower()
    part = _block_part(name)
    if part is not None:
        return {"gemm1": "MLP block GEMM1 (wgmma)",
                "qkv": "attention block QKV GEMM (wgmma)",
                "residual": "block residual GEMMs (wgmma: attention out, "
                            "MLP GEMM2)",
                "core": "ftc forward, no lse (K2; attention-block core)",
                "ln": "block LayerNorm rows"}[part]
    if "rca_fused_kernel" in n or "rca_fwd_" in n:
        return "rca_fused kernel"
    if _wide_bwd(n):            # K4b on the tensor cores at head dim 80
        return "mha_flash_bwd kernels (tensor cores)"
    if "wide_kernel" in n:      # the tensor-core forward at head dims 80 / 88
        return ("mha_fwd_lse kernel (tensor cores)" if _wide_lse(n)
                else "mha kernel")
    if "ftc::" in n:            # the tensor-core route: K4a, K4b
        if "fwd_kernel" in n:
            return "mha_fwd_lse kernel (tensor cores)"
        return "mha_flash_bwd kernels (tensor cores)"
    if "tc32::" in n:           # the fp32 pair on 3xTF32: K4a / K7a, K4b / K7b
        return ("mha_fwd_lse kernel (3xTF32)" if "fwd_kernel" in n
                else "mha_flash_bwd kernel (3xTF32)")
    if "mha_kernel" in n:
        return "mha kernel"
    if "attn_heads_kernel" in n or "attn_out_kernel" in n:
        return "attention block kernels (CUDA cores)"
    if "mlp_kernel" in n:
        return "fused MLP block kernel (fp32)"
    if "rca_bwd" in n:
        return "rca_fused_bwd kernel"
    if "mha_bwd" in n:
        return "mha_flash_bwd kernels"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if "conv" in n or "fprop" in n or "dgrad" in n or "wgrad" in n:
        return "convolutions"
    if "gemm" in n or "nvjet" in n or "cutlass" in n or "cublas" in n:
        return "matmuls"
    return "elementwise + reductions"


def profile_batch(model, batch, dtype, device, reps=3):
    from garbage_classification_rca_tpu_torch.cli.test_both import (
        make_both_eval_step)

    return profile_step(make_both_eval_step(model, dtype), batch, device,
                        reps)


def _conv_kind(name: str) -> str:
    """Phase 10's kinds: convolutions (cuDNN runs the 1x1 ones as CUTLASS
    GEMMs; the one fc GEMM of a batch counts here too), the copy, cast and
    layout kernels (``.contiguous``, stack / concat, dtype casts, memcpy,
    NCHW <-> NHWC transposes), and the rest (bias adds, activations,
    pooling, normalization)."""
    n = name.lower()
    if any(k in n for k in ("copy", "memcpy", "memset", "nchwtonhwc",
                            "nhwctonchw", "transpose", "catarray")):
        return "copies, casts, transposes"
    if _kind(name) in ("convolutions", "matmuls"):
        return "convolutions (1x1 as GEMMs)"
    return "elementwise + reductions"


def _trace(run, reps, kind):
    """torch.profiler (CUPTI) over `reps` calls ``run(r)``, tracing the
    device's activity alone (host operator events add overhead to the
    window and ten times the time to read the trace): (device ms a call by
    `kind` of kernel, largest first; the kernels as (ms a call, count a
    call, name); device operations a call; host wall ms a call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in range(reps):
            run(r)
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kinds, top, ops = {}, [], 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms = us / 1e3 / reps
        kinds[kind(e.key)] = kinds.get(kind(e.key), 0.0) + ms
        ops += e.count
        top.append((ms, e.count // reps, e.key.replace("void at::native::",
                                                       "")[:160]))
    return (dict(sorted(kinds.items(), key=lambda kv: -kv[1])), top,
            ops // reps, wall)


def profile_step(step, batch, device, reps=3, kind=_kind):
    """torch.profiler over `reps` eval steps of one batch (``_trace``):
    device time per batch by `kind` of kernel, the top kernels, and the
    device's idle share of the window (1 - kernel time / host wall
    time)."""
    import torch

    with torch.inference_mode():
        dev = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        step(dev)[0].cpu()
        kinds, top, _, wall = _trace(lambda r: step(dev)[0].cpu(), reps,
                                     kind)
    busy = sum(kinds.values())
    out = {"device_ms_per_batch": busy, "wall_ms_per_batch": wall,
           "idle_share": 1.0 - busy / wall, "by_kind_ms": kinds}
    print(f"  profile of one batch (mean of {reps}): device {busy:.2f} ms, "
          f"wall {out['wall_ms_per_batch']:.2f} ms, idle share "
          f"{out['idle_share']:.3f}", flush=True)
    for k, ms in out["by_kind_ms"].items():
        print(f"    {k:26s} {ms:8.3f} ms  {ms / busy:6.1%}", flush=True)
    for ms, cnt, name in sorted(top, reverse=True)[:8]:
        print(f"    top: {ms:8.3f} ms x{cnt:<4d} {name}", flush=True)
    return out


def check_model(device, n_batches, batch_size, results):
    import copy

    import torch

    from garbage_classification_rca_tpu_torch.cli.test_both import (
        run_multimodal_eval)
    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        WordPieceTokenizer)
    from garbage_classification_rca_tpu_torch.models.fusion import multimodal
    from garbage_classification_rca_tpu_torch.nn.fold import fold_batchnorm

    ok = True
    cfg = multimodal.FusionConfig(strategy="MM_RCA", reverse=True)
    t0 = time.perf_counter()
    model32 = multimodal.build_fusion_model(
        cfg, device=device, generator=torch.Generator().manual_seed(SEED + 2))
    _randomize_bn(model32,
                  torch.Generator(device=device).manual_seed(SEED + 5))
    fold_batchnorm(model32.image, 1e-3)
    tok = WordPieceTokenizer.from_vocab_file(
        "tests/fixtures/vocab/wordpiece/vocab.txt")
    data = SyntheticBatcher(n_batches * batch_size, batch_size, (480, 480),
                            tok, 64, SEED + 3)
    first = data.batches[0]
    print(f"  model built in {time.perf_counter() - t0:.1f} s", flush=True)

    # fp32, TF32 off: kernel path vs plain path on 8 samples
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = {k: v[:8] for k, v in first.items()}
    lk = _logits(model32, small, torch.float32, device)
    with plain_versions():
        lp = _logits(model32, small, torch.float32, device)
    d32 = float((lk - lp).abs().max())
    same32 = bool((lk.argmax(-1) == lp.argmax(-1)).all())
    fin = bool(torch.isfinite(lk).all())
    ok &= fin and same32 and d32 <= 1e-4 and tuple(lk.shape) == (8, 4)
    print(f"  fp32 logits kernel vs plain: max|d|={d32:.3e}, argmax equal="
          f"{same32}, finite={fin}", flush=True)
    torch.backends.cudnn.allow_tf32 = True

    # bf16: the CLI's cast, then the measured run_eval
    model = copy.deepcopy(model32).to(torch.bfloat16)
    del model32
    torch.cuda.empty_cache()
    dtype = torch.bfloat16
    run_multimodal_eval(model, SyntheticBatcher(batch_size, batch_size,
                                                (480, 480), tok, 64, SEED + 4),
                        batch_size, device, dtype, progress=False)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _zero_counters()
    acc, labels, preds, stats = run_multimodal_eval(
        model, data, batch_size, device, dtype, progress=False)
    torch.cuda.synchronize()
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated(device)
    results["launches"] = launches
    want = _want_launches(rca_fused=n_batches, mha_tc=6 * n_batches)
    ok &= launches == want and len(preds) == n_batches * batch_size
    print(f"  launches over {n_batches} batches: {launches} (want {want})",
          flush=True)
    # two more runs of the same loop, for the spread (counters not read)
    rates = [stats["samples_per_s"]]
    p50s = [stats["p50_step_s"] * 1e3]
    for _ in range(2):
        _, _, _, st = run_multimodal_eval(model, data, batch_size, device,
                                          dtype, progress=False)
        rates.append(st["samples_per_s"])
        p50s.append(st["p50_step_s"] * 1e3)
    print(f"  run_eval x3 over {n_batches} batches of {batch_size}: "
          f"samples/s {sorted(rates)}, p50 batch ms {sorted(p50s)} (the p50 "
          f"includes the prediction readback); peak memory "
          f"{peak / 2**30:.2f} GiB; accuracy on random labels {acc:.2f} %",
          flush=True)
    results["model"] = {"samples_per_s": sorted(rates)[1],
                        "samples_per_s_runs": rates,
                        "p50_batch_ms": sorted(p50s)[1],
                        "peak_mem_gib": peak / 2**30,
                        "batches": n_batches, "batch": batch_size}

    results["model"]["profile"] = profile_batch(model, data.batches[0],
                                                dtype, device)

    # bf16 logits, kernel path vs plain path, on two batches
    agree, n, dmax = 0, 0, 0.0
    for batch in data.batches[:2]:
        lk = _logits(model, batch, dtype, device)
        with plain_versions():
            lp = _logits(model, batch, dtype, device)
        fin = bool(torch.isfinite(lk).all())
        ok &= fin and tuple(lk.shape) == (batch_size, 4)
        agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
        n += lk.shape[0]
        dmax = max(dmax, float((lk - lp).abs().max()))
    frac = agree / n
    ok &= frac >= 0.98 and dmax <= 0.05
    results["model"].update(argmax_agreement=frac, max_logit_diff=dmax)
    print(f"  bf16 logits kernel vs plain over {n} samples: argmax "
          f"agreement {frac:.4f}, max|d|={dmax:.3e}", flush=True)

    # one batch at --seq_len=512 (the exact-parity length, config.py): the
    # fusion tower's attention past the tensor-core route's N, on the CUDA
    # cores
    data = SyntheticBatcher(SEQ512_BATCH, SEQ512_BATCH, (480, 480), tok, 512,
                            SEED + 6)
    _zero_counters()
    run_multimodal_eval(model, data, SEQ512_BATCH, device, dtype,
                        progress=False)
    torch.cuda.synchronize()
    launches = _read_counters()
    results["launches_seq512"] = launches
    lk = _logits(model, data.batches[0], dtype, device)
    with plain_versions():
        lp = _logits(model, data.batches[0], dtype, device)
    d512 = float((lk - lp).abs().max())
    want = _want_launches(rca_fused=1, mha=6)
    good = (launches == want and bool(torch.isfinite(lk).all())
            and d512 <= 0.05)
    ok &= good
    results["model"]["seq512"] = {"batch": SEQ512_BATCH,
                                  "max_logit_diff": d512}
    print(f"  one batch of {SEQ512_BATCH} at seq 512: launches "
          f"{_shown(launches)} (want {_shown(want)}, every other 0), bf16 "
          f"logits kernel vs plain max|d|={d512:.3e} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    return ok


# ---------------------------------------------------------------------------
# phase 5: the MM-RCA train path
# ---------------------------------------------------------------------------

TRAIN_BATCH, ACC_STEPS = 16, 10        # the MM_RCA.sh recipe
TRAIN_IMAGE = 480
TRAIN_LAUNCHES = {"rca_fused": 1, "rca_fused_bwd": 1, "mha_fwd_lse": 6,
                  "mha_flash_bwd_tc32": 6}          # per microbatch


def _counters():
    from garbage_classification_rca_tpu_torch.kernels import mha_fused
    from garbage_classification_rca_tpu_torch.kernels import rca_fused
    from garbage_classification_rca_tpu_torch.kernels import (
        transformer_block as tb)

    return {"rca_fused": rca_fused.rca_fused, "mha": mha_fused.mha,
            "rca_fused_bwd": rca_fused.rca_fused_bwd,
            "mha_fwd_lse": mha_fused.mha_fwd_lse,
            "mha_flash_bwd": mha_fused.mha_flash_bwd,
            "mha_fwd_lse_drop": mha_fused.mha_fwd_lse_drop,
            "mha_flash_bwd_drop": mha_fused.mha_flash_bwd_drop,
            "postnorm_attn_block": tb.postnorm_attn_block,
            "postnorm_mlp_block": tb.postnorm_mlp_block,
            "attn_block": tb.attn_block, "mlp_block": tb.mlp_block}


BLOCK_KERNELS = ("postnorm_attn_block", "postnorm_mlp_block", "attn_block",
                 "mlp_block")


def _want_launches(**counts):
    """Every counter's expected value: the named ones, 0 for the rest."""
    return {k: counts.get(k, 0) for k in _read_counters()}


def _zero_counters():
    for fn in _counters().values():
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches = {r: 0 for r in fn.route_launches}


_ROUTE_KEYS = {"cuda_core": "", "cuda_cores": "", "tc": "_tc",
               "tensor_cores": "_tc", "tc32": "_tc32", "staged": "",
               "per_sample": "_per_sample"}


def _read_counters():
    """{kernel: launches}; K2, K4a / K4b / K7a / K7b and K5a / K6a count
    each route on its own: "mha_fwd_lse" is the CUDA-core kernel,
    "mha_fwd_lse_tc" the tensor-core one, "mha_flash_bwd_tc32" /
    "mha_flash_bwd_drop_tc32" the 3xTF32 one; "attn_block" the CUDA-core
    body, "attn_block_tc" the tensor-core chain; "rca_fused" /
    "rca_fused_bwd" K1's / K3's staged route, "rca_fused_per_sample" /
    "rca_fused_bwd_per_sample" their first versions."""
    out = {}
    for k, fn in _counters().items():
        if hasattr(fn, "route_launches"):
            for route, n in fn.route_launches.items():
                out[k + _ROUTE_KEYS[route]] = n
        else:
            out[k] = fn.launches
    return out


def _train_stack(tok, acc, batch, seed, device):
    """[acc, B, ...] device stack of synthetic 480x480 uint8 images and
    WordPiece texts, labels over the 4 classes, every sample valid."""
    import numpy as np
    import torch

    data = SyntheticBatcher(acc * batch, batch, (TRAIN_IMAGE, TRAIN_IMAGE),
                            tok, 64, seed)
    return {k: torch.from_numpy(np.stack([b[k] for b in data.batches])).to(
        device) for k in data.batches[0]}


def _microbatch_grads(model, cfg, mb, image_dtype, key, class_weights):
    """One microbatch's loss and {name: grad} through the model's current
    call sites (kernels or plain versions), the recipe's augmentation,
    head dropout and class weights."""
    import torch

    from garbage_classification_rca_tpu_torch.data.augment import (
        augment_batch)
    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)
    from garbage_classification_rca_tpu_torch.train.loss import (
        cross_entropy_loss_and_weight)

    k_in, k_model = key.split(2)
    for p in model.parameters():
        p.grad = None
    with torch.enable_grad():
        x = augment_batch(mb["image"], 1.0, k_in.generator(mb["image"].device))
        logits = model(mb["input_ids"], mb["attention_mask"],
                       normalize_on_device(x, dtype=image_dtype),
                       train=True, key=k_model)
        loss, _ = cross_entropy_loss_and_weight(logits, mb["label"],
                                                class_weights, 0.0,
                                                mb["valid"])
        loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None
             else p.grad.detach().clone()        # unread (CLIP's trans_conv)
             for n, p in model.named_parameters()}
    return float(loss.detach()), grads


def exact_zero_grads(model):
    """Names of the parameters whose gradient is zero in exact arithmetic,
    so that both paths give rounding noise there: every attention key bias
    (softmax ignores a per-row constant), and the ``project.bn.bias`` of a
    block without residual whose output reaches the loss only through 1x1
    convs each followed by a train-mode BN (which removes a per-channel
    constant; a 3x3 conv's zero padding would not): the first block of an
    "mb" stage followed by "mb" blocks or the head. A residual block's
    ``project.bn.bias`` joins them whenever stochastic depth keeps every
    sample of the batch. The hierarchical head reads the outputs of stages
    3 and 6 (its pooled maps), which their blocks' residuals carry from the
    first block: those stages' first blocks are not among them there."""
    names = {n for n, _ in model.named_parameters() if n.endswith("k.b")}
    stages = model.image_cfg.stages
    read = (3, 6) if model.cfg.strategy == "hierarchical" else ()
    for si, (btype, expand, _, stride, c_in, c_out, n) in enumerate(stages):
        nxt = stages[si + 1][0] if si + 1 < len(stages) else "mb"
        plain = stride != 1 or c_in != c_out
        if btype == "mb" and plain and (n > 1 or nxt == "mb") \
                and si not in read:
            names.add(f"image.stages.{si}.0.project.bn.bias")
        # a lone fused block (cut tables) feeding the 1x1 conv + BN that
        # opens an "mb" stage or the head
        if btype == "fused" and expand != 1 and plain and n == 1 \
                and nxt == "mb" and si not in read:
            names.add(f"image.stages.{si}.0.project.bn.bias")
        # without stochastic depth every residual "mb" block keeps every
        # sample
        if btype == "mb" and model.image_cfg.sd_prob == 0:
            names.update(f"image.stages.{si}.{j}.project.bn.bias"
                         for j in range(n) if j or not plain)
    return names


def _sibling(name):
    """The weight a bias that may be rounding noise is sized against."""
    return name[:-1] + "w" if name.endswith("k.b") else name[:-4] + "scale"


GRAD_CHECK_SEEDS = 1          # microbatches (and draws) the paths are held on
# bf16 limits of compare_train_paths. The image tower's and the noise
# biases' are about twice the largest gap that the "one_ulp" noise floor
# gave on the H100 (lowest image-tower cosine 0.99891, largest noise-bias
# ratio 0.0189, over three microbatches; PERF.md, PR 2 findings)
BF16_COS = 0.999              # cosine, every gradient outside the image tower
BF16_COS_IMAGE = 0.998        # cosine, the image tower
BF16_NOISE_BIAS = 4e-2        # |d| / max(|g|, sibling |g|)max, noise biases


def _bf16_bits(x):
    """(sign bit, magnitude bits) of a bf16 tensor, as int32."""
    import torch

    b = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    return b & 0x8000, b & 0x7FFF


def _ulp_steps(a, b):
    """(How many bf16 ulps `a` lies from `b`, counted on the magnitude;
    whether their signs agree)."""
    sa, ma = _bf16_bits(a)
    sb, mb = _bf16_bits(b)
    return ma - mb, (sa == sb) | ((ma == 0) & (mb == 0))


def _move_ulps(x, steps):
    """bf16 `x` with each magnitude moved by `steps` ulps, kept finite."""
    import torch

    s, m = _bf16_bits(x)
    bits = s | (m + steps).clamp(0, 0x7F7F)
    return torch.where(bits >= 0x8000, bits - 0x10000, bits).to(
        torch.int16).view(torch.bfloat16)


@contextlib.contextmanager
def di_tap(store, replace=None):
    """Route the model's RCA call site (kernel or plain, whichever is set)
    through an identity on its image input i that, on the way back, hands
    on ``replace(di)`` when given (else di) and records it in
    ``store["di"]``."""
    import torch

    from garbage_classification_rca_tpu_torch.models.fusion import multimodal

    class _Tap(torch.autograd.Function):
        @staticmethod
        def forward(ctx, i):
            return i.view_as(i)

        @staticmethod
        def backward(ctx, g):
            if replace is not None:
                g = replace(g)
            store["di"] = g.detach().clone()
            return g

    inner = multimodal.rca_fused_trainable
    multimodal.rca_fused_trainable = (
        lambda p, t, i, **kw: inner(p, t, _Tap.apply(i), **kw))
    try:
        yield
    finally:
        multimodal.rca_fused_trainable = inner


def _grad_scores(ga, gb, fp32, exact_zero):
    """Gradients `ga` against `gb` (the plain path's), name by name:
    (scores, biases, zeros, finite). scores: (value, name) — fp32 the
    largest |d| over the tensor's largest |g|, bf16 the cosine (1 - that
    ratio for a tensor whose gradient is below 1e-6 of the model's largest,
    held to that floor); biases: |d| / max(own, sibling |g|max) of the
    biases that may be rounding noise; zeros: |g| / sibling |g|max of those
    zero in exact arithmetic, the larger over both paths."""
    import torch

    mx = {n: float(g.abs().max()) for n, g in gb.items()}
    floor = 1e-6 * max(mx.values())
    scores, biases, zeros, finite = [], [], [], True
    for n in gb:
        finite &= bool(torch.isfinite(ga[n]).all())
        d = float((ga[n] - gb[n]).abs().max())
        if n.endswith(("k.b", "project.bn.bias")):
            sib = max(mx[_sibling(n)], floor)
            biases.append((d / max(mx[n], sib), n))
            if n in exact_zero:
                zeros.append((max(mx[n], float(ga[n].abs().max())) / sib, n))
        elif fp32 or mx[n] < floor:
            r = d / max(mx[n], floor)
            scores.append((r if fp32 else 1.0 - r, n))
        else:
            scores.append((float(torch.nn.functional.cosine_similarity(
                ga[n].flatten().double(), gb[n].flatten().double(), dim=0)),
                n))
    scores.sort(reverse=fp32)
    biases.sort(reverse=True)
    zeros.sort(reverse=True)
    return scores, biases, zeros, finite


def _worst(xs, image=None, k=3):
    """The first `k` (value, name) of a sorted list, optionally only the
    image tower's (image=True) or only the rest (image=False)."""
    if image is not None:
        xs = [x for x in xs if x[1].startswith("image.") == image]
    return [(float(f"{v:.5g}"), n) for v, n in xs[:k]]


def compare_train_paths(model, cfg, stack, class_weights, results,
                        seeds=GRAD_CHECK_SEEDS):
    """Kernel path against plain path, same weights and same draws,
    deterministic cuDNN, on GRAD_CHECK_SEEDS microbatches with their own
    draws. fp32 images with TF32 off: the loss within 1e-5 relative, every
    gradient within 1e-4 of its tensor's largest |g|. bf16 images: the loss
    within 1e-3 relative, each gradient's cosine >= BF16_COS, >=
    BF16_COS_IMAGE in the image tower. A tensor whose gradient is below
    1e-6 of the model's largest is held to that floor instead of its own
    size (1e-4 in fp32, 1e-2 in bf16). The biases that may be rounding
    noise (key biases, ``project.bn.bias``) are held, to 1e-4 in fp32 and
    BF16_NOISE_BIAS in bf16, to the larger of their own and their sibling
    weight's largest |g|; those zero in exact arithmetic
    (``exact_zero_grads``) must also stay below 0.1 of that sibling's on
    both paths.

    The image tower's bf16 gradients come out of a 57-block bf16 backward
    fed by the RCA block's di, which K3 and the plain version each round to
    bf16 from fp32 sums taken in different orders. Two more plain-path runs
    per microbatch size that: "kernel_di" hands the image tower K3's own di
    (its gradients should then match the kernel path's), and "one_ulp"
    moves the plain di by one bf16 ulp, up or down, at random elements, as
    many as K3's di differs in (its cosines against the plain path are the
    noise floor of a di that is right to one rounding). They are reported,
    not judged."""
    import torch

    from garbage_classification_rca_tpu_torch.nn.core import Key

    ok = True
    exact_zero = exact_zero_grads(model)
    checks = {"fp32": [], "bf16": []}
    # deterministic cuDNN algorithms: the two paths must differ only where
    # the kernels do, not by the atomics of a convolution's backward
    torch.backends.cudnn.deterministic = True
    for seed in range(seeds):
        mb = {k: v[seed] for k, v in stack.items()}
        key = Key(SEED + 11 + seed)
        for image_dtype in (torch.float32, torch.bfloat16):
            fp32 = image_dtype == torch.float32
            tag = "fp32" if fp32 else "bf16"
            torch.backends.cudnn.allow_tf32 = not fp32
            run = lambda: _microbatch_grads(model, cfg, mb, image_dtype, key,
                                            class_weights)
            dk, dp = {}, {}
            with di_tap(dk):
                lk, gk = run()
            with plain_versions(), di_tap(dp):
                lp, gp = run()
            rel = abs(lk - lp) / max(abs(lp), 1e-30)
            scores, biases, zeros, finite = _grad_scores(gk, gp, fp32,
                                                         exact_zero)
            row = {"seed": seed, "loss_kernel": lk, "loss_plain": lp,
                   "loss_rel": rel, "worst_image": _worst(scores, True),
                   "worst_rest": _worst(scores, False),
                   "worst_noise_bias": _worst(biases),
                   "exact_zero_worst": _worst(zeros)}
            ok &= finite and lk == lk and rel <= (1e-5 if fp32 else 1e-3)
            ok &= all(z <= 0.1 for z, _ in zeros)
            ok &= all(r <= (1e-4 if fp32 else BF16_NOISE_BIAS)
                      for r, _ in biases)
            if fp32:
                ok &= all(r <= 1e-4 for r, _ in scores)
            else:
                ok &= all(c >= (BF16_COS_IMAGE if n.startswith("image.")
                                else BF16_COS) for c, n in scores)
                steps, same = _ulp_steps(dk["di"], dp["di"])
                differ = (steps != 0) | ~same
                share = float(differ.float().mean())
                row["di_share_differing"] = share
                row["di_share_of_those_one_ulp"] = float(
                    (same & (steps.abs() == 1)).sum()) / max(
                        int(differ.sum()), 1)
                row["di_ulps_max_same_sign"] = int(
                    torch.where(same, steps.abs(), 0).max())
                row["di_sign_flips"] = int((~same).sum())
                g = torch.Generator(device=steps.device).manual_seed(
                    SEED + 13 + seed)
                u = torch.rand(steps.shape, generator=g, device=steps.device)
                nudge = torch.where(u < share / 2, -1,
                                    torch.where(u < share, 1, 0))
                for what, replace in (
                        ("kernel_di", lambda di: dk["di"]),
                        ("one_ulp", lambda di: _move_ulps(di, nudge))):
                    with plain_versions(), di_tap({}, replace):
                        _, gx = run()
                    ref = gk if what == "kernel_di" else gp
                    s, b_, _, _ = _grad_scores(gx, ref, False, exact_zero)
                    row[f"{what}_worst_image"] = _worst(s, True)
                    row[f"{what}_worst_noise_bias"] = _worst(b_)
                    del gx
            print(f"  train microbatch {seed}, kernel vs plain, {tag} images:"
                  f" {json.dumps(row)}", flush=True)
            checks[tag].append(row)
            del gk, gp
            torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    results["grad_check_fp32"] = checks["fp32"]
    results["grad_check_bf16"] = checks["bf16"]
    return ok


def profile_train_step(step, stack, key, reps=1, acc_steps=None,
                       quiet=False, kind=None):
    """torch.profiler over `reps` train steps (``_trace``): device time by
    `kind` of kernel (default ``_kind``) and the device's idle share of
    the window (printed unless `quiet`)."""
    kinds, top, ops, wall = _trace(
        lambda r: float(step(stack, key.fold_in(r))[0]), reps,
        kind or _kind)
    busy = sum(kinds.values())
    out = {"device_ms_per_step": busy, "wall_ms_per_step": wall,
           "idle_share": 1.0 - busy / wall, "device_ops_per_step": ops,
           "by_kind_ms": kinds}
    if quiet:
        return out
    print(f"  profile of one train step ({acc_steps or ACC_STEPS} "
          f"microbatches): device "
          f"{busy:.1f} ms, wall {out['wall_ms_per_step']:.1f} ms, idle share "
          f"{out['idle_share']:.3f}, {out['device_ops_per_step']} device "
          f"operations (kernels, copies, fills) launched", flush=True)
    for k, ms in out["by_kind_ms"].items():
        print(f"    {k:26s} {ms:9.2f} ms  {ms / busy:6.1%}", flush=True)
    for ms, cnt, name in sorted(top, reverse=True)[:10]:
        print(f"    top: {ms:9.2f} ms x{cnt:<5d} {name}", flush=True)
    return out


def check_train(device, results):
    """The full-width train step: EffNetV2-M at 480x480, 6-layer DistilBERT
    at seq 64, fp32 master weights, bf16 images, batch 16 x acc 10, SGD lr
    0.0016 reg 0.03, class weights, augmentation at p=1.0, head dropout
    0.6. Three optimizer steps all trainable and one with the phase-1
    mask, launch counts per microbatch asserted; then the kernel path
    against the plain path (``compare_train_paths``) on the seeded weights,
    restored after the steps, so that the check does not depend on the
    steps' nondeterministic convolution backward."""
    import torch

    from garbage_classification_rca_tpu_torch.cli.main_both import (
        fusion_head_mask)
    from garbage_classification_rca_tpu_torch.data.augment import (
        augment_batch)
    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)
    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        WordPieceTokenizer)
    from garbage_classification_rca_tpu_torch.models.fusion import multimodal
    from garbage_classification_rca_tpu_torch.nn.core import Key
    from garbage_classification_rca_tpu_torch.train.loop import (
        make_train_step)
    from garbage_classification_rca_tpu_torch.train.optim import (
        make_optimizer)

    ok = True
    cfg = multimodal.FusionConfig(strategy="MM_RCA", reverse=True,
                                  drop_ratio=0.6,
                                  image_or_text_dropout_chance=0.0)
    model = multimodal.build_fusion_model(
        cfg, device=device, generator=torch.Generator().manual_seed(SEED + 8))
    tok = WordPieceTokenizer.from_vocab_file(
        "tests/fixtures/vocab/wordpiece/vocab.txt")
    stack = _train_stack(tok, ACC_STEPS, TRAIN_BATCH, SEED + 9, device)
    class_weights = torch.tensor([0.8, 1.1, 0.9, 1.3], device=device)
    dtype = torch.bfloat16
    # the seeded weights, which the kernel-vs-plain gradient check runs on
    # (the steps below change them through cuDNN's nondeterministic
    # backward atomics and every train-path kernel's rounding)
    seeded = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def batch_to_inputs(mb, key):
        x = augment_batch(mb["image"], 1.0, key.generator(device))
        return (mb["input_ids"], mb["attention_mask"],
                normalize_on_device(x, dtype=dtype))

    def make(trainable):
        opt = make_optimizer("sgd", model.named_parameters(), 0.0016,
                             0.03, trainable)
        return make_train_step(model, opt, batch_to_inputs=batch_to_inputs,
                               class_weights=class_weights)

    step_all = make(None)
    step_heads = make(fusion_head_mask(model))
    key = Key(SEED + 10)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith(("text.layers.0.q", "image.stem", "rca_ti",
                               "final_with_everything"))}
    float(step_all(stack, key.fold_in(100))[0])     # warm-up step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _zero_counters()
    t0 = time.perf_counter()
    losses, norms = [], []
    for s, step in enumerate((step_all, step_all, step_all, step_heads)):
        loss, mb_losses, nrm = step(stack, key.fold_in(s))
        losses.append(float(loss))
        norms.append({k: float(v) for k, v in nrm.items()})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated(device)
    n_mb = 4 * ACC_STEPS
    want = _want_launches(**{k: v * n_mb
                             for k, v in TRAIN_LAUNCHES.items()})
    ok &= launches == want
    print(f"  launches over 4 steps x {ACC_STEPS} microbatches: {launches} "
          f"(want {want})", flush=True)
    changed = {n: bool((p.detach() != before[n]).any())
               for n, p in model.named_parameters() if n in before}
    finite = all(l == l and abs(l) < float("inf") for l in losses)
    ok &= finite and all(changed.values())
    steps_per_s = 4 / wall
    print(f"  4 optimizer steps in {wall:.2f} s: {steps_per_s:.3f} steps/s, "
          f"{steps_per_s * ACC_STEPS * TRAIN_BATCH:.1f} train samples/s; "
          f"peak memory {peak / 2**30:.2f} GiB; losses {losses}; grad norms "
          f"{[round(n['grad_norm'], 4) for n in norms]}; params changed "
          f"{changed}", flush=True)
    results["train"] = {"steps_per_s": steps_per_s,
                        "samples_per_s": steps_per_s * ACC_STEPS * TRAIN_BATCH,
                        "step_ms": wall / 4 * 1e3, "peak_mem_gib": peak / 2**30,
                        "losses": losses, "norms": norms,
                        "batch": TRAIN_BATCH, "acc_steps": ACC_STEPS}
    results["train_launches"] = launches
    results["train"]["profile"] = profile_train_step(step_all, stack,
                                                     key.fold_in(200))
    # one further step with the DistilBERT tower's internal dropout on
    model.cfg = dataclasses.replace(cfg, hf_internal_dropout=True)
    _zero_counters()
    loss_hf = float(step_all(stack, key.fold_in(300))[0])
    torch.cuda.synchronize()
    launches = _read_counters()
    model.cfg = cfg
    want = _want_launches(rca_fused=ACC_STEPS, rca_fused_bwd=ACC_STEPS,
                          mha_fwd_lse_drop_tc32=6 * ACC_STEPS,
                          mha_flash_bwd_drop_tc32=6 * ACC_STEPS)
    ok &= launches == want and loss_hf == loss_hf
    print(f"  one step with hf_internal_dropout: loss {loss_hf:.4f}, "
          f"launches { {k: v for k, v in launches.items() if v} } (want "
          f"{ {k: v for k, v in want.items() if v} }, every other 0)",
          flush=True)
    results["train_hf_dropout_launches"] = launches
    model.load_state_dict(seeded)
    del seeded
    ok &= compare_train_paths(model, cfg, stack, class_weights, results)
    del model, stack
    torch.cuda.empty_cache()
    return ok


def _write_jpeg_tree(root, n_train, n_val, seed, size=480, vocab=None):
    """A 4-class tree ``<root>_Train`` / ``<root>_Val`` of `size` x `size`
    JPEGs whose file names carry the text: the class's two words, or with
    `vocab` (a list of words) 2 to 6 words drawn from it for each file."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    words = {"black": "coffee cup", "blue": "water bottle",
             "green": "banana peel", "ttr": "battery pack"}
    for split, n in (("_Train", n_train), ("_Val", n_val)):
        for c, (cls, text) in enumerate(words.items()):
            d = os.path.join(root + split, cls)
            os.makedirs(d, exist_ok=True)
            for j in range(n // 4):
                arr = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
                arr[..., c % 3] //= 2
                if vocab:
                    text = " ".join(rng.choice(vocab, rng.integers(2, 7)))
                Image.fromarray(arr).save(
                    os.path.join(d, f"{text.replace(' ', '_')}_{j}.jpg"),
                    quality=90)


def drive_eval_main(cli, argv, acc=None):
    """The eval CLI's ``main(argv)`` end to end, its report step included,
    in the current directory: (ok, csv name). Its report CSV must be the
    only one under ``test_set_reports/``, carry `acc` (``evaluate()``'s
    accuracy on the same files, in %; None: the accuracy ``main``
    returns) in its name and in its "accuracy" column, and ``main`` must
    return `acc`."""
    import csv
    import glob
    import os
    import shutil

    shutil.rmtree("test_set_reports", ignore_errors=True)
    got = cli.main(argv)
    acc = got if acc is None else acc
    csvs = glob.glob("test_set_reports/*/*_report_test_set_acc_*.csv")
    ok = len(csvs) == 1 and got == acc
    name = os.path.basename(csvs[0]) if csvs else None
    if len(csvs) == 1:
        with open(csvs[0], newline="") as f:
            rows = list(csv.reader(f))
        col = rows[0].index("accuracy")
        ok &= (name.endswith(f"_acc_{acc:.2f}.csv")
               and all(abs(float(r[col]) * 100.0 - acc) <= 1e-9
                       for r in rows[1:]))
    print(f"  cli.{cli.__name__.rsplit('.', 1)[-1]}.main: accuracy {got}, "
          f"report {name} {'ok' if ok else 'FAIL'}", flush=True)
    return ok, name


def check_cli(device, results):
    """``cli.main_both`` with the MM_RCA.sh flags for 1 + 1 epochs on a
    synthetic 480x480 tree (64 train, 32 val), then ``cli.test_both``'s
    ``evaluate()`` on its BEST checkpoint and its ``main()`` end to end
    (``drive_eval_main``: the report CSV; the PNG only where matplotlib
    and seaborn import); in this process, in a work directory of the
    checkout, deleted afterwards."""
    import glob
    import json as _json
    import os
    import shutil

    from garbage_classification_rca_tpu_torch.cli import main_both, test_both
    from garbage_classification_rca_tpu_torch.config import args_parser

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    _write_jpeg_tree(os.path.join(work, "garbage"), 64, 32, SEED + 12)
    vocab = os.path.join(here, "tests", "fixtures", "vocab", "wordpiece")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        best = main_both.main([
            "--dataset_folder_name=garbage", "--late_fusion=MM_RCA",
            "--ft_epochs=1", "--epochs=1", "--prob_aug=1.00",
            "--acc_steps=10", "--acc_steps_FT=10", "--opt=sgd",
            "--text_model=distilbert", "--fraction_lr=3",
            "--image_text_dropout=0.0", "--balance_weights", "--reg=0.03",
            "--lr=0.0016", "--reverse", f"--vocab_dir={vocab}"])
        train_s = time.perf_counter() - t0
        rows = [_json.loads(line) for f in glob.glob("runs/*.jsonl")
                for line in open(f)]
        bests = glob.glob("model_weights/MM_RCA_distilbert/BEST_*")
        t0 = time.perf_counter()
        argv = ["--late_fusion=MM_RCA", "--reverse",
                "--text_model=distilbert", f"--model_path={best.best_path}",
                "--dataset_folder_name=garbage_Val", f"--vocab_dir={vocab}",
                "--eval_batch_size=16"]
        acc, _, preds, _ = test_both.evaluate(args_parser(argv))
        test_s = time.perf_counter() - t0
        main_ok, report = drive_eval_main(test_both, argv, acc)
        bests = [os.path.join(work, b) for b in bests]
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    ok = (len(rows) == 2 and all(r["avg_loss"] == r["avg_loss"]
                                  for r in rows)
          and {r["phase"] for r in rows} == {"train", "fine_tune"}
          and all({"val_acc_image_only", "val_acc_text_only"} <= set(r)
                  for r in rows)
          and best.best_path in bests and main_ok
          and 0.0 <= acc <= 100.0 and len(preds) == 32)
    print(f"  cli.main_both 1+1 epochs in {train_s:.1f} s: "
          f"{[(r['phase'], round(r['avg_loss'], 4), r['val_acc']) for r in rows]}"
          f", BEST {os.path.basename(best.best_path or '')}; cli.test_both "
          f"on it in {test_s:.1f} s: accuracy {acc:.2f} %", flush=True)
    results["cli"] = {"train_s": train_s, "test_s": test_s, "rows": rows,
                      "test_acc": acc, "report": report}
    return ok


# ---------------------------------------------------------------------------
# phases 6 and 7: the unimodal eval paths
# ---------------------------------------------------------------------------

TEXT_BATCH, TEXT_BATCHES, TEXT_SEQ = 256, 4, 64    # TEXT_ARCHS eval batch
IMAGE_BATCH, IMAGE_BATCHES, IMAGE_SIZE = 64, 4, 224   # IMAGE_ARCHS, B/16


class SyntheticEvalBatcher:
    """Batcher stand-in for the unimodal eval loops: seeded token ids from
    the tokenizer's vocabulary (text; `words`: the words to draw the texts
    from instead, for a tokenizer without a vocabulary) or uint8 images,
    fixed-shape batches made before the run."""

    def __init__(self, n_batches, batch_size, seed, *, tokenizer=None,
                 seq_len=0, image_size=0, words=None):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.m = list(range(n_batches * batch_size))
        self.batches = []
        words = words or (tokenizer and [w for w in tokenizer.vocab
                                         if w.isalpha()])
        for _ in range(n_batches):
            batch = {"label": rng.integers(0, 4, batch_size).astype(np.int32),
                     "valid": np.ones(batch_size, np.int32)}
            if tokenizer is not None:
                texts = [" ".join(rng.choice(words, rng.integers(2, 40)))
                         for _ in range(batch_size)]
                enc = tokenizer.encode_batch(texts, seq_len)
                batch["input_ids"] = enc.input_ids
                batch["attention_mask"] = enc.attention_mask
            else:
                batch["image"] = rng.integers(
                    0, 256, (batch_size, image_size, image_size, 3),
                    dtype=np.uint8)
            self.batches.append(batch)

    def iter_batches(self, batch_size, *, shuffle=False, **_):
        assert batch_size == len(self.batches[0]["label"]) and not shuffle
        yield from self.batches


def argmax_check(lk, lp, truth):
    """The bf16 eval check of the kernel path `lk` against the plain path
    `lp` (logits of the same samples), with `truth` the fp32 model's
    logits on the plain path: max |d| <= 0.05 over every sample, and argmax
    agreement >= 0.98 over the samples whose fp32 top-2 margin is above the
    noise floor, twice the largest |lp - truth| of this run. Under the floor
    bf16 rounding alone can flip the argmax (random weights leave many
    near ties); above it the plain path's argmax is the fp32 model's, so a
    flip there is the kernel path's own. At least half the samples must lie
    above the floor. Returns (ok, {kernel_plain, kernel_plain_all,
    kernel_fp32, plain_fp32, noise_floor, excluded, samples,
    max_logit_diff}); kernel_plain_all is the agreement over every sample
    (the bar before the floor, printed beside it)."""
    agree = lambda a, b: float((a.argmax(-1) == b.argmax(-1)).float().mean())
    floor = 2.0 * float((lp - truth).abs().max())
    top2 = truth.topk(2, dim=-1).values
    keep = (top2[:, 0] - top2[:, 1]) > floor
    n, kept = len(truth), int(keep.sum())
    out = {"kernel_plain": agree(lk[keep], lp[keep]) if kept else 0.0,
           "kernel_plain_all": agree(lk, lp),
           "kernel_fp32": agree(lk, truth), "plain_fp32": agree(lp, truth),
           "noise_floor": floor, "excluded": n - kept, "samples": n,
           "max_logit_diff": float((lk - lp).abs().max())}
    ok = (out["max_logit_diff"] <= 0.05 and 2 * kept >= n
          and out["kernel_plain"] >= 0.98)
    return ok, out


def _agreement_line(agr):
    return (f"argmax agreement {agr['kernel_plain']:.4f} over the "
            f"{agr['samples'] - agr['excluded']} of {agr['samples']} samples "
            f"above the noise floor {agr['noise_floor']:.3e} (over all "
            f"{agr['kernel_plain_all']:.4f}), max|d|="
            f"{agr['max_logit_diff']:.3e}; against the fp32 model: kernel "
            f"{agr['kernel_fp32']:.4f}, plain {agr['plain_fp32']:.4f}")


def _fp32_truth(model32, batches, logits_of):
    """The fp32 model's logits on the plain path (TF32 off everywhere)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    with plain_versions():
        out = [logits_of(model32, b, torch.float32) for b in batches]
    torch.backends.cudnn.allow_tf32 = True
    return out


def _eval_path(title, model32, data, run, step_of, logits_of, per_batch,
               device, results, key):
    """One unimodal eval path on the card. fp32 (TF32 off) on 16 samples:
    kernel path against plain path. Then bf16: a warm-up run, the measured
    run with the counters zeroed before and read after, two more runs for
    the spread, a profile of one batch, and the logits of two batches
    against the plain path (``argmax_check``)."""
    import copy

    import torch

    ok = True
    batch_size = len(data.batches[0]["label"])
    n_batches = len(data.batches)
    print(f"  {title}: {n_batches} batches of {batch_size}", flush=True)
    small = {k: v[:16] for k, v in data.batches[0].items()}
    torch.backends.cudnn.allow_tf32 = False
    lk = logits_of(model32, small, torch.float32)
    with plain_versions():
        lp = logits_of(model32, small, torch.float32)
    torch.backends.cudnn.allow_tf32 = True
    d32 = float((lk - lp).abs().max())
    same32 = bool((lk.argmax(-1) == lp.argmax(-1)).all())
    fin = bool(torch.isfinite(lk).all())
    ok &= fin and same32 and d32 <= 1e-4 and tuple(lk.shape) == (16, 4)
    print(f"  fp32 logits kernel vs plain: max|d|={d32:.3e}, argmax equal="
          f"{same32}, finite={fin}", flush=True)

    truth = _fp32_truth(model32, data.batches[:2], logits_of)
    model = copy.deepcopy(model32).to(torch.bfloat16)
    del model32
    torch.cuda.empty_cache()
    run(model, data)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _zero_counters()
    acc, labels, preds, stats = run(model, data)
    torch.cuda.synchronize()
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated(device)
    want = _want_launches(**{k: v * n_batches for k, v in per_batch.items()})
    ok &= launches == want and len(preds) == n_batches * batch_size
    print(f"  launches over {n_batches} batches: "
          f"{ {k: v for k, v in launches.items() if v} } (want "
          f"{ {k: v for k, v in want.items() if v} }, every other 0)",
          flush=True)
    results[key + "_launches"] = launches
    rates, p50s = [stats["samples_per_s"]], [stats["p50_step_s"] * 1e3]
    for _ in range(2):
        st = run(model, data)[3]
        rates.append(st["samples_per_s"])
        p50s.append(st["p50_step_s"] * 1e3)
    print(f"  run_eval x3 over {n_batches} batches of {batch_size}: "
          f"samples/s {sorted(rates)}, p50 batch ms {sorted(p50s)} (the p50 "
          f"includes the prediction readback); peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    results[key] = {"samples_per_s": sorted(rates)[1],
                    "samples_per_s_runs": rates,
                    "p50_batch_ms": sorted(p50s)[1],
                    "peak_mem_gib": peak / 2**30, "batches": n_batches,
                    "batch": batch_size,
                    "profile": profile_step(step_of(model), data.batches[0],
                                            device)}
    lks, lps = [], []
    for batch in data.batches[:2]:
        lks.append(logits_of(model, batch, torch.bfloat16))
        with plain_versions():
            lps.append(logits_of(model, batch, torch.bfloat16))
        ok &= bool(torch.isfinite(lks[-1]).all())
        ok &= tuple(lks[-1].shape) == (batch_size, 4)
    good, agr = argmax_check(torch.cat(lks), torch.cat(lps), torch.cat(truth))
    ok &= good
    results[key].update(argmax_agreement=agr["kernel_plain"],
                        max_logit_diff=agr["max_logit_diff"],
                        agreement=agr, fp32_max_logit_diff=d32)
    print(f"  bf16 logits kernel vs plain: {_agreement_line(agr)} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    del model
    torch.cuda.empty_cache()
    return ok


def _text_logits(model, batch, dtype):
    import torch

    dev = next(model.parameters()).device
    with torch.inference_mode():
        return model(torch.from_numpy(batch["input_ids"]).to(dev),
                     torch.from_numpy(batch["attention_mask"]).to(dev)
                     ).float()


def _image_logits(model, batch, dtype):
    import torch

    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)

    dev = next(model.parameters()).device
    with torch.inference_mode():
        return model(normalize_on_device(
            torch.from_numpy(batch["image"]).to(dev), dtype=dtype)).float()


def check_text_eval(device, results):
    """BERT-base at full width and depth through ``run_eval`` with
    ``cli.test_text``'s step; then one batch each of DistilBERT and
    RoBERTa for the launch counts and the agreement with the plain path."""
    import torch

    from garbage_classification_rca_tpu_torch.cli.test_text import (
        make_text_eval_step)
    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        get_tokenizer)
    from garbage_classification_rca_tpu_torch.eval.harness import run_eval
    from garbage_classification_rca_tpu_torch.models.registry import (
        get_text_model)

    keys = ("input_ids", "attention_mask", "label", "valid")

    def run(model, data):
        return run_eval(make_text_eval_step(model), data,
                        len(data.batches[0]["label"]), device, keys=keys,
                        progress=False)

    def build(name, seed):
        return get_text_model(name).build(
            4, generator=torch.Generator().manual_seed(seed)).to(device).eval()

    tok = get_tokenizer("bert", vocab_dir="tests/fixtures/vocab/wordpiece")
    data = SyntheticEvalBatcher(TEXT_BATCHES, TEXT_BATCH, SEED + 30,
                                tokenizer=tok, seq_len=TEXT_SEQ)
    ok = _eval_path("bert", build("bert", SEED + 31), data, run,
                    make_text_eval_step, _text_logits,
                    {"postnorm_attn_block_tc": 12, "postnorm_mlp_block": 12},
                    device, results, "text_eval")
    for name, vocab, layers in (("distilbert", "wordpiece", 6),
                                ("roberta", "bpe", 12)):
        tok = get_tokenizer(name, vocab_dir=f"tests/fixtures/vocab/{vocab}")
        one = SyntheticEvalBatcher(1, TEXT_BATCH, SEED + 32, tokenizer=tok,
                                   seq_len=TEXT_SEQ)
        model = build(name, SEED + 33)
        truth = _fp32_truth(model, one.batches, _text_logits)[0]
        model = model.to(torch.bfloat16)
        _zero_counters()
        preds = run(model, one)[2]
        torch.cuda.synchronize()
        launches = _read_counters()
        want = _want_launches(postnorm_attn_block_tc=layers,
                              postnorm_mlp_block=layers)
        lk = _text_logits(model, one.batches[0], torch.bfloat16)
        with plain_versions():
            lp = _text_logits(model, one.batches[0], torch.bfloat16)
        agreed, agr = argmax_check(lk, lp, truth)
        good = (launches == want and len(preds) == TEXT_BATCH
                and bool(torch.isfinite(lk).all()) and agreed)
        ok &= good
        print(f"  {name}: one batch of {TEXT_BATCH}, launches "
              f"{ {k: v for k, v in launches.items() if v} }, bf16 kernel vs "
              f"plain {_agreement_line(agr)} {'ok' if good else 'FAIL'}",
              flush=True)
        results[f"text_eval_{name}"] = {
            "argmax_agreement": agr["kernel_plain"],
            "max_logit_diff": agr["max_logit_diff"], "agreement": agr}
        del model
        torch.cuda.empty_cache()
    return ok


def check_image_eval(device, results):
    """ViT-B/16 at full width and depth through ``run_image_eval``."""
    import torch

    from garbage_classification_rca_tpu_torch.eval.harness import (
        make_eval_step, run_image_eval)
    from garbage_classification_rca_tpu_torch.models.registry import (
        get_image_model)

    def run(model, data):
        return run_image_eval(model, data, len(data.batches[0]["label"]),
                              device, torch.bfloat16, progress=False)

    model = get_image_model("transformer_B16").build(
        4, generator=torch.Generator().manual_seed(SEED + 41)).to(device).eval()
    with torch.no_grad():    # torchvision's class token starts at zero
        model.class_token.normal_(0.0, 0.02, generator=torch.Generator(
            device=device).manual_seed(SEED + 42))
    data = SyntheticEvalBatcher(IMAGE_BATCHES, IMAGE_BATCH, SEED + 40,
                                image_size=IMAGE_SIZE)
    return _eval_path("transformer_B16", model, data, run,
                      lambda m: make_eval_step(m, torch.bfloat16),
                      _image_logits, {"attn_block_tc": 12, "mlp_block": 12},
                      device, results, "image_eval")


_DISTILBERT_KEYS = {"q": "attention.q_lin", "k": "attention.k_lin",
                    "v": "attention.v_lin", "out": "attention.out_lin",
                    "ln_att": "sa_layer_norm", "fc1": "ffn.lin1",
                    "fc2": "ffn.lin2", "ln_ffn": "output_layer_norm"}
_VIT_KEYS = {"ln_1": "ln_1", "ln_2": "ln_2", "out": "self_attention.out_proj",
             "fc1": "mlp.linear_1", "fc2": "mlp.linear_2"}
_LEAF = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias"}
_SHUFFLE_UNIT = {"b1_dw": ("branch1.0", "branch1.1"),
                 "b1_pw": ("branch1.2", "branch1.3"),
                 "b2_pw1": ("branch2.0", "branch2.1"),
                 "b2_dw": ("branch2.3", "branch2.4"),
                 "b2_pw2": ("branch2.5", "branch2.6")}
_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def _shufflenet_key(parts):
    """torchvision's ShuffleNetV2 key of a port parameter or buffer
    (``stages.0.1.b2_dw.bn.mean`` -> ``stage2.1.branch2.4.running_mean``)."""
    if parts[0] == "fc":
        return f"fc.{_LEAF[parts[1]]}"
    if parts[0] == "stages":
        pre = f"stage{int(parts[1]) + 2}.{parts[2]}."
        conv, bn = (pre + k for k in _SHUFFLE_UNIT[parts[3]])
    else:                                     # conv1, conv5
        conv, bn = f"{parts[0]}.0", f"{parts[0]}.1"
    if parts[-2] == "conv":
        return f"{conv}.weight"
    return f"{bn}.{_BN_LEAF[parts[-1]]}"


def _reference_state_dict(model, kind):
    """The port model's weights under the reference checkpoint's key names
    (HF DistilBERT classifier under ``model.`` / ``out.``; torchvision ViT
    and ShuffleNetV2; HF ``BartForSequenceClassification``): the port's
    parameters already have torch's layouts."""
    sd = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        leaf = _LEAF.get(parts[-1])
        if kind == "shuffle_net":
            key = _shufflenet_key(parts)
        elif kind == "bart":
            key = _bart_key(parts)
        elif kind == "distilbert":
            if parts[0] == "head":
                key = f"out.{leaf}"
            elif parts[1] == "layers":
                key = (f"model.transformer.layer.{parts[2]}."
                       f"{_DISTILBERT_KEYS[parts[3]]}.{leaf}")
            else:
                key = "model.embeddings." + {
                    "word_emb": "word_embeddings.weight",
                    "pos_emb": "position_embeddings.weight",
                    "ln_emb": f"LayerNorm.{leaf}"}[parts[1]]
        elif parts[0] == "layers":
            pre = f"encoder.layers.encoder_layer_{parts[1]}."
            key = pre + (f"self_attention.in_proj_{leaf}" if parts[2] == "qkv"
                         else f"{_VIT_KEYS[parts[2]]}.{leaf}")
        else:
            key = {"class_token": "class_token",
                   "pos_embedding": "encoder.pos_embedding",
                   "conv_proj": f"conv_proj.{leaf}",
                   "ln": f"encoder.ln.{leaf}",
                   "head": f"heads.head.{leaf}"}[parts[0]]
        sd[key] = t.detach().cpu().contiguous()
    return sd


def check_eval_clis(device, results):
    """``cli.test_text`` (DistilBERT, 6 layers) and ``cli.test_image``
    (ViT-B/16, 12 layers) on reference-layout ``.pth`` files with random
    seeded weights and a synthetic 32-image JPEG tree: the CLIs' own
    loading, tokenizing, decoding and evaluation (``evaluate()``; the
    report step runs in phases 5 and 9, on the trainers' BEST files), with
    the launch counts of two batches of 16 asserted."""
    import os
    import shutil

    import torch

    from garbage_classification_rca_tpu_torch.cli import test_image, test_text
    from garbage_classification_rca_tpu_torch.config import args_parser
    from garbage_classification_rca_tpu_torch.models.registry import (
        get_image_model, get_text_model)

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_eval_clis")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    vocab = os.path.join(here, "tests", "fixtures", "vocab", "wordpiece")
    out = {}
    try:
        _write_jpeg_tree(os.path.join(work, "garbage"), 0, 32, SEED + 50)
        val = os.path.join(work, "garbage_Val")
        for cli, flag, name, kind, counts in (
                (test_text, "text_model", "distilbert", "distilbert",
                 {"postnorm_attn_block_tc": 6, "postnorm_mlp_block": 6}),
                (test_image, "image_model", "transformer_B16", "vit",
                 {"attn_block_tc": 12, "mlp_block": 12})):
            getter = get_text_model if kind == "distilbert" else \
                get_image_model
            model = getter(name).build(
                4, generator=torch.Generator().manual_seed(SEED + 51))
            ckpt = os.path.join(work, f"{name}.pth")
            torch.save(_reference_state_dict(model, kind), ckpt)
            del model
            _zero_counters()
            t0 = time.perf_counter()
            res = cli.evaluate(args_parser([
                f"--{flag}={name}", f"--model_path={ckpt}",
                f"--dataset_folder_name={val}", f"--vocab_dir={vocab}",
                "--eval_batch_size=16"]))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            acc, labels, preds = res[0], res[1], res[2]
            launches = _read_counters()
            want = _want_launches(**{k: 2 * v for k, v in counts.items()})
            good = (launches == want and len(preds) == 32
                    and 0.0 <= acc <= 100.0
                    and sorted(set(labels.tolist())) == [0, 1, 2, 3])
            print(f"  cli.{cli.__name__.rsplit('.', 1)[-1]} --{flag}={name} "
                  f"on 32 JPEGs in {secs:.1f} s: accuracy {acc:.2f} %, "
                  f"launches { {k: v for k, v in launches.items() if v} } "
                  f"{'ok' if good else 'FAIL'}", flush=True)
            out[name] = {"seconds": secs, "acc": acc, "ok": good}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    results["eval_clis"] = out
    return all(v["ok"] for v in out.values())


# ---------------------------------------------------------------------------
# phases 8 and 9: the unimodal train paths
# ---------------------------------------------------------------------------

TEXT_TRAIN_BATCH, BERT_TRAIN_BATCH = 128, 64     # TEXT_ARCHS train batches
IMAGE_TRAIN_BATCH = 128                          # IMAGE_ARCHS, B/16
UNIMODAL_LR, UNIMODAL_REG = 0.001, 0.01          # the CLIs' defaults


def _unimodal_grads(model, forward, inputs, mb, class_weights, key):
    """One microbatch's loss and {name: grad} through the model's current
    call sites (kernels or plain versions)."""
    import torch

    from garbage_classification_rca_tpu_torch.train.loss import (
        cross_entropy_loss_and_weight)

    for p in model.parameters():
        p.grad = None
    with torch.enable_grad():
        logits = forward(*inputs, train=True, key=key)
        loss, _ = cross_entropy_loss_and_weight(
            logits, mb["label"], class_weights, 0.0, mb["valid"])
        loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None
             else p.grad.detach().clone()        # unread (CLIP's trans_conv)
             for n, p in model.named_parameters()}
    return float(loss.detach()), grads


def compare_unimodal_paths(title, model, forward, inputs, mb, class_weights,
                           key, fp32):
    """Kernel path against plain path from the same key (the dropout masks
    are drawn outside the kernels, so both paths see the same ones). fp32
    with TF32 off: the loss within 1e-5 relative, every gradient within
    1e-4 of its tensor's largest |g|; bf16 activations: 1e-3 and cosine >=
    BF16_COS. The attention key biases, whose gradient is zero in exact
    arithmetic, are held to their sibling weight's scale as
    ``compare_train_paths`` holds them."""
    import torch

    exact_zero = {n for n, _ in model.named_parameters()
                  if n.endswith("k.b")}
    torch.backends.cudnn.allow_tf32 = not fp32
    lk, gk = _unimodal_grads(model, forward, inputs, mb, class_weights, key)
    with plain_versions():
        lp, gp = _unimodal_grads(model, forward, inputs, mb, class_weights,
                                 key)
    torch.backends.cudnn.allow_tf32 = True
    rel = abs(lk - lp) / max(abs(lp), 1e-30)
    scores, biases, zeros, finite = _grad_scores(gk, gp, fp32, exact_zero)
    ok = finite and lk == lk and rel <= (1e-5 if fp32 else 1e-3)
    ok &= all(z <= 0.1 for z, _ in zeros)
    ok &= all(r <= (1e-4 if fp32 else BF16_NOISE_BIAS) for r, _ in biases)
    ok &= all((r <= 1e-4) if fp32 else (r >= BF16_COS) for r, _ in scores)
    row = {"loss_kernel": lk, "loss_plain": lp, "loss_rel": rel,
           "worst": _worst(scores), "worst_key_bias": _worst(biases),
           "exact_zero_worst": _worst(zeros)}
    print(f"  {title}, kernel vs plain, {'fp32' if fp32 else 'bf16'}: "
          f"{json.dumps(row)} {'ok' if ok else 'FAIL'}", flush=True)
    return ok, row


def _timed_steps(steps, stack, key, device):
    """Run the steps; (wall seconds, losses, launches, peak bytes)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _zero_counters()
    t0 = time.perf_counter()
    losses = [float(step(stack, key.fold_in(s))[0])
              for s, step in enumerate(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, losses, _read_counters(), torch.cuda.max_memory_allocated(
        device)


def _shown(launches):
    return {k: v for k, v in launches.items() if v}


def check_text_train(device, results):
    """The text trainer's step at full width and depth: DistilBERT, batch
    128, seq 64, fp32, SGD, head dropout 0.6, class weights, with and
    without ``hf_internal_dropout``; one step of BERT-base with it."""
    import torch

    from garbage_classification_rca_tpu_torch.cli.main_text import (
        head_keys_for, train_forward)
    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        get_tokenizer)
    from garbage_classification_rca_tpu_torch.models.registry import (
        get_text_model)
    from garbage_classification_rca_tpu_torch.nn.core import Key
    from garbage_classification_rca_tpu_torch.train.loop import (
        head_only_mask, make_train_step)
    from garbage_classification_rca_tpu_torch.train.optim import (
        make_optimizer)

    ok = True
    tok = get_tokenizer("distilbert",
                        vocab_dir="tests/fixtures/vocab/wordpiece")
    class_weights = torch.tensor([0.8, 1.1, 0.9, 1.3], device=device)
    key = Key(SEED + 70)

    def stack_of(batch, seq=TEXT_SEQ):
        data = SyntheticEvalBatcher(1, batch, SEED + 71, tokenizer=tok,
                                    seq_len=seq)
        return {k: torch.from_numpy(v)[None].to(device)
                for k, v in data.batches[0].items()}

    def inputs(mb, key):
        return (mb["input_ids"], mb["attention_mask"])

    def make(model, flag, trainable=None):
        opt = make_optimizer("sgd", model.named_parameters(), UNIMODAL_LR,
                             UNIMODAL_REG, trainable)
        return make_train_step(
            model, opt, batch_to_inputs=inputs, class_weights=class_weights,
            forward=train_forward(model, flag))

    model = get_text_model("distilbert").build(
        4, generator=torch.Generator().manual_seed(SEED + 72)).to(
            device).eval()
    stack = stack_of(TEXT_TRAIN_BATCH)
    step_on = make(model, True)
    step_heads = make(model, True, head_only_mask(
        model, head_keys_for("distilbert")))
    step_off = make(model, False)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n in ("encoder.layers.0.q.w", "encoder.word_emb.w",
                       "head.w")}
    float(step_on(stack, key.fold_in(100))[0])             # warm-up
    float(step_off(stack, key.fold_in(101))[0])
    wall, losses, launches, peak = _timed_steps(
        (step_on, step_on, step_on, step_heads), stack, key, device)
    want = _want_launches(mha_fwd_lse_drop_tc32=6 * 4,
                          mha_flash_bwd_drop_tc32=6 * 4)
    changed = {n: bool((p.detach() != before[n]).any())
               for n, p in model.named_parameters() if n in before}
    finite = all(l == l and abs(l) < float("inf") for l in losses)
    ok &= launches == want and finite and all(changed.values())
    print(f"  distilbert, hf_internal_dropout: 4 steps of {TEXT_TRAIN_BATCH} "
          f"in {wall:.3f} s: {4 / wall:.2f} steps/s, "
          f"{4 * TEXT_TRAIN_BATCH / wall:.1f} samples/s; peak memory "
          f"{peak / 2**30:.2f} GiB; losses {losses}; launches "
          f"{_shown(launches)} (want {_shown(want)}, every other 0); params "
          f"changed {changed}", flush=True)
    results["text_train_launches"] = launches
    results["text_train"] = {
        "steps_per_s": 4 / wall, "samples_per_s": 4 * TEXT_TRAIN_BATCH / wall,
        "step_ms": wall / 4 * 1e3, "peak_mem_gib": peak / 2**30,
        "losses": losses, "batch": TEXT_TRAIN_BATCH, "seq": TEXT_SEQ}
    wall, losses, launches, _ = _timed_steps((step_off,) * 4, stack, key,
                                             device)
    want = _want_launches(mha_fwd_lse=6 * 4, mha_flash_bwd_tc32=6 * 4)
    ok &= launches == want and all(l == l for l in losses)
    print(f"  distilbert, flag off: 4 steps in {wall:.3f} s: "
          f"{4 / wall:.2f} steps/s; launches {_shown(launches)} (want "
          f"{_shown(want)}, every other 0)", flush=True)
    results["text_train"]["flag_off_steps_per_s"] = 4 / wall
    results["text_train_flag_off_launches"] = launches
    results["text_train"]["profile"] = profile_train_step(
        step_on, stack, key.fold_in(200), reps=3, acc_steps=1)
    results["text_train"]["profile_flag_off"] = profile_train_step(
        step_off, stack, key.fold_in(201), reps=3, acc_steps=1)
    # the step's device time with both kernels on 3xTF32 ("new"; the
    # default with the flag), both on the CUDA cores ("old") and the 3xTF32
    # backward beside the CUDA-core forward ("new_bwd"; the default without
    # the flag), in this call: new, old, new_bwd, new_bwd, old, new
    forced = {"new": dict(fwd="tc32"),
              "old": dict(fwd="cuda_core", bwd="cuda_core"),
              "new_bwd": dict(fwd="cuda_core")}
    for flag, step in (("on", step_on), ("off", step_off)):
        ab = {r: [] for r in forced}
        for r in ("new", "old", "new_bwd", "new_bwd", "old", "new"):
            with flash_routes(**forced[r]):
                ab[r].append(profile_train_step(
                    step, stack, key.fold_in(210), reps=3, acc_steps=1,
                    quiet=True)["device_ms_per_step"])
        results["text_train"][f"route_ab_flag_{flag}"] = ab
        print(f"  distilbert, flag {flag}: device ms per step (new, old, "
              f"new_bwd, new_bwd, old, new): both kernels on 3xTF32 "
              f"{ab['new']}, both on the CUDA cores {ab['old']}, the 3xTF32 "
              f"backward beside the CUDA-core forward {ab['new_bwd']}",
              flush=True)
    mb = {k: v[0] for k, v in stack.items()}
    good, row = compare_unimodal_paths(
        "distilbert microbatch with hf_internal_dropout", model,
        train_forward(model, True),
        inputs(mb, None), mb, class_weights, Key(SEED + 73), True)
    ok &= good
    results["text_train"]["grad_check"] = row

    # --seq_len=512 (config.py's exact-parity length): the pair past the
    # 3xTF32 routes' N, on the CUDA cores, with the flag and without
    stack = stack_of(SEQ512_BATCH, 512)
    for flag, step, want in (
            ("on", step_on, _want_launches(mha_fwd_lse_drop=6,
                                           mha_flash_bwd_drop=6)),
            ("off", step_off, _want_launches(mha_fwd_lse=6,
                                             mha_flash_bwd=6))):
        _, losses, launches, _ = _timed_steps((step,), stack, key, device)
        results[f"text_train_seq512_{flag}_launches"] = launches
        good = launches == want and losses[0] == losses[0]
        ok &= good
        print(f"  distilbert at seq 512, batch {SEQ512_BATCH}, flag {flag}: "
              f"loss {losses[0]:.4f}, launches {_shown(launches)} (want "
              f"{_shown(want)}, every other 0) {'ok' if good else 'FAIL'}",
              flush=True)
    mb = {k: v[0] for k, v in stack.items()}
    good, row = compare_unimodal_paths(
        "distilbert microbatch at seq 512 with hf_internal_dropout", model,
        train_forward(model, True),
        inputs(mb, None), mb, class_weights, Key(SEED + 75), True)
    ok &= good
    results["text_train"]["grad_check_seq512"] = row
    del model, step_on, step_heads, step_off
    torch.cuda.empty_cache()

    bert = get_text_model("bert").build(
        4, generator=torch.Generator().manual_seed(SEED + 74)).to(
            device).eval()
    stack = stack_of(BERT_TRAIN_BATCH)
    step = make(bert, True)
    wall, losses, launches, _ = _timed_steps((step,), stack, key, device)
    want = _want_launches(mha_fwd_lse_drop_tc32=12,
                          mha_flash_bwd_drop_tc32=12)
    ok &= launches == want and losses[0] == losses[0]
    print(f"  bert, hf_internal_dropout: one step of {BERT_TRAIN_BATCH}: "
          f"loss {losses[0]:.4f}, launches {_shown(launches)} (want "
          f"{_shown(want)}, every other 0)", flush=True)
    del bert, step
    torch.cuda.empty_cache()
    return ok


def check_image_train(device, results):
    """The image trainer's step at full width and depth: ViT-B/16, batch
    128, 224x224, bf16 images over fp32 master weights, augmentation at
    p=1.0, SGD, class weights."""
    import numpy as np
    import torch

    from garbage_classification_rca_tpu_torch.cli.main_image import (
        head_keys_for)
    from garbage_classification_rca_tpu_torch.data.augment import (
        augment_batch)
    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)
    from garbage_classification_rca_tpu_torch.models.registry import (
        get_image_model)
    from garbage_classification_rca_tpu_torch.nn.core import Key
    from garbage_classification_rca_tpu_torch.train.loop import (
        head_only_mask, make_train_step)
    from garbage_classification_rca_tpu_torch.train.optim import (
        make_optimizer)

    ok = True
    model = get_image_model("transformer_B16").build(
        4, generator=torch.Generator().manual_seed(SEED + 80)).to(
            device).eval()
    with torch.no_grad():    # torchvision's class token starts at zero
        model.class_token.normal_(0.0, 0.02, generator=torch.Generator(
            device=device).manual_seed(SEED + 81))
    rng = np.random.default_rng(SEED + 82)
    stack = {"image": torch.from_numpy(rng.integers(
                 0, 256, (1, IMAGE_TRAIN_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3),
                 dtype=np.uint8)).to(device),
             "label": torch.from_numpy(rng.integers(
                 0, 4, (1, IMAGE_TRAIN_BATCH)).astype(np.int32)).to(device),
             "valid": torch.ones((1, IMAGE_TRAIN_BATCH), dtype=torch.int32,
                                 device=device)}
    class_weights = torch.tensor([0.8, 1.1, 0.9, 1.3], device=device)
    key = Key(SEED + 83)

    def inputs_in(dtype):
        def batch_to_inputs(mb, key):
            x = augment_batch(mb["image"], 1.0, key.generator(device))
            return (normalize_on_device(x, dtype=dtype),)
        return batch_to_inputs

    def make(trainable=None):
        opt = make_optimizer("sgd", model.named_parameters(), UNIMODAL_LR,
                             UNIMODAL_REG, trainable)
        return make_train_step(model, opt,
                               batch_to_inputs=inputs_in(torch.bfloat16),
                               class_weights=class_weights)

    step_all = make()
    step_heads = make(head_only_mask(model, head_keys_for("transformer_B16")))
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n in ("layers.0.qkv.w", "conv_proj.w", "head.w")}
    float(step_all(stack, key.fold_in(100))[0])            # warm-up
    wall, losses, launches, peak = _timed_steps(
        (step_all, step_all, step_all, step_heads), stack, key, device)
    want = _want_launches(mha_fwd_lse_tc=12 * 4, mha_flash_bwd_tc=12 * 4)
    changed = {n: bool((p.detach() != before[n]).any())
               for n, p in model.named_parameters() if n in before}
    finite = all(l == l and abs(l) < float("inf") for l in losses)
    ok &= launches == want and finite and all(changed.values())
    print(f"  transformer_B16: 4 steps of {IMAGE_TRAIN_BATCH} in {wall:.3f} "
          f"s: {4 / wall:.2f} steps/s, {4 * IMAGE_TRAIN_BATCH / wall:.1f} "
          f"samples/s; peak memory {peak / 2**30:.2f} GiB; losses {losses}; "
          f"launches {_shown(launches)} (want {_shown(want)}, every other "
          f"0); params changed {changed}", flush=True)
    results["image_train_launches"] = launches
    results["image_train"] = {
        "steps_per_s": 4 / wall,
        "samples_per_s": 4 * IMAGE_TRAIN_BATCH / wall,
        "step_ms": wall / 4 * 1e3, "peak_mem_gib": peak / 2**30,
        "losses": losses, "batch": IMAGE_TRAIN_BATCH,
        "profile": profile_train_step(step_all, stack, key.fold_in(200),
                                      reps=2, acc_steps=1)}
    # kernel path against plain path on 32 samples
    mb = {k: v[0, :32] for k, v in stack.items()}
    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        k_in, k_model = Key(SEED + 84).split(2)
        good, row = compare_unimodal_paths(
            "transformer_B16 microbatch of 32", model, model,
            inputs_in(dtype)(mb, k_in), mb, class_weights, k_model,
            dtype == torch.float32)
        ok &= good
        checks[str(dtype)[6:]] = row
    results["image_train"]["grad_check"] = checks
    del model, step_all, step_heads, stack
    torch.cuda.empty_cache()
    return ok


def check_train_clis(device, results):
    """``cli.main_text --hf_internal_dropout`` and ``cli.main_image`` for
    1 + 1 epochs on a synthetic 224x224 JPEG tree (64 train, 32 val; the
    file names carry the text), then ``cli.test_text`` / ``cli.test_image``
    evaluate the BEST files (``evaluate()``, launches counted) and run
    end to end on them (``main()``, ``drive_eval_main``). In this process,
    in a work directory of the checkout, deleted afterwards."""
    import glob
    import json as _json
    import os
    import shutil

    import torch

    from garbage_classification_rca_tpu_torch.cli import (
        main_image, main_text, test_image, test_text)
    from garbage_classification_rca_tpu_torch.config import args_parser

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_train_clis")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    vocab = os.path.join(here, "tests", "fixtures", "vocab", "wordpiece")
    cwd = os.getcwd()
    out = {}
    common = ["--dataset_folder_name=garbage", "--epochs=1", "--ft_epochs=1",
              "--batch_size=16", "--batch_size_FT=16", "--balance_weights",
              "--opt=sgd", f"--vocab_dir={vocab}"]
    # phase 1 and 2: 4 steps each; the val eval: 32 samples in one batch
    runs = (
        ("main_text", main_text, test_text,
         ["--text_model=distilbert", "--hf_internal_dropout", "--seq_len=64"],
         ["--text_model=distilbert", "--seq_len=64"], "distilbert",
         {"mha_fwd_lse_drop_tc32": 48, "mha_flash_bwd_drop_tc32": 48,
          "postnorm_attn_block": 12, "postnorm_mlp_block": 12},
         {"postnorm_attn_block_tc": 6, "postnorm_mlp_block": 6}),
        ("main_image", main_image, test_image,
         ["--image_model=transformer_B16", "--prob_aug=1.0"],
         ["--image_model=transformer_B16"], "transformer_B16",
         {"mha_fwd_lse_tc": 96, "mha_flash_bwd_tc": 96, "mha_tc": 24},
         {"attn_block_tc": 12, "mlp_block": 12}))
    try:
        _write_jpeg_tree(os.path.join(work, "garbage"), 64, 32, SEED + 90,
                         size=IMAGE_SIZE)
        os.chdir(work)
        for name, trainer, tester, flags, test_flags, model_name, want_train, \
                want_test in runs:
            _zero_counters()
            t0 = time.perf_counter()
            best = trainer.main(common + flags + [f"--name={name}"])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = _read_counters()
            rows = [_json.loads(line)
                    for f in glob.glob(f"runs/{name}_*.jsonl")
                    for line in open(f)]
            _zero_counters()
            argv = test_flags + [
                f"--model_path={best.best_path}",
                "--dataset_folder_name=garbage_Val", f"--vocab_dir={vocab}",
                "--eval_batch_size=32"]
            res = tester.evaluate(args_parser(argv))
            torch.cuda.synchronize()
            test_launches = _read_counters()
            acc, preds = res[0], res[2]
            main_ok, report = drive_eval_main(tester, argv, acc)
            good = (len(rows) == 2
                    and all(r["avg_loss"] == r["avg_loss"] for r in rows)
                    and {r["phase"] for r in rows} == {"train", "fine_tune"}
                    and launches == _want_launches(**want_train)
                    and test_launches == _want_launches(**want_test)
                    and os.path.isfile(best.best_path)
                    and os.path.dirname(best.best_path).endswith(model_name)
                    and 0.0 <= acc <= 100.0 and len(preds) == 32
                    and main_ok)
            print(f"  cli.{name} 1+1 epochs in {train_s:.1f} s: "
                  f"{[(r['phase'], round(r['avg_loss'], 4), r['val_acc']) for r in rows]}"
                  f", launches {_shown(launches)}; its BEST file in the test "
                  f"CLI: accuracy {acc:.2f} %, launches "
                  f"{_shown(test_launches)} {'ok' if good else 'FAIL'}",
                  flush=True)
            agr = best_file_agreement(tester, argv)
            print(f"  its BEST file, bf16 kernel path against the plain "
                  f"path and the fp32 model: {_agreement_line(agr)} "
                  f"(recorded, not a gate)", flush=True)
            out[name] = {"train_s": train_s, "rows": rows, "test_acc": acc,
                         "report": report, "ok": good, "agreement": agr}
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    results["train_clis"] = out
    return all(v["ok"] for v in out.values())


def best_file_agreement(tester, argv):
    """The bf16 eval check of ``argmax_check`` on a trainer's BEST file
    (weights with trained margins, where the random-weight models of
    phases 6 and 7 have near ties): the test CLI's ``evaluate()`` three
    times, the model's logits caught by a forward hook: bf16 on the
    kernels, bf16 on the plain versions, fp32 (TF32 off) on the plain
    versions. Returns argmax_check's numbers, among them the agreement over
    every sample beside the one above the noise floor."""
    import torch

    from garbage_classification_rca_tpu_torch.config import args_parser

    load = tester.load_unimodal_model

    def logits(extra):
        caught = []

        def hooked(*a, **kw):
            model = load(*a, **kw)
            model.register_forward_hook(lambda mod, inp, out: caught.append(
                (out if torch.is_tensor(out) else out[0]).detach().float()))
            return model

        tester.load_unimodal_model = hooked
        try:
            tester.evaluate(args_parser(argv + extra))
        finally:
            tester.load_unimodal_model = load
        return torch.cat(caught)

    lk = logits(["--compute_dtype=bfloat16"])
    with plain_versions():
        lp = logits(["--compute_dtype=bfloat16"])
        torch.backends.cudnn.allow_tf32 = False
        truth = logits(["--compute_dtype=float32"])
        torch.backends.cudnn.allow_tf32 = True
    return argmax_check(lk, lp, truth)[1]


# ---------------------------------------------------------------------------
# phase 10: the conv image backbones (cuDNN convolutions, no hand-written
# kernel)
# ---------------------------------------------------------------------------

CONV_NAMES = ("shuffle_net", "res18", "res50", "res152", "mb", "convnext",
              "b0", "b4", "b5", "eff_v2_small", "eff_v2_medium",
              "eff_v2_large")
CONV_BATCHES = 8           # ShuffleNetV2's run_image_eval: 8 batches of 256
CONV_CHECK = 32            # samples of each model's fp32 / bf16 checks
SHUFFLE_BENCH_BATCH = 512  # bench.py's bench_shufflenet batch


def _conv_model(name, seed, device):
    """`name` at full width with random seeded weights and BatchNorm
    statistics, fp32, unfolded, on the device."""
    import torch

    from garbage_classification_rca_tpu_torch.models.registry import (
        get_image_model)

    model = get_image_model(name).build(
        4, generator=torch.Generator().manual_seed(seed))
    _randomize_bn(model, torch.Generator().manual_seed(seed + 1))
    return model.to(device).eval()


def bf16_vs_fp32(l16, l32):
    """Phase 10's bf16 check: the bf16 model's logits against the same
    (folded) model's in fp32 with TF32 off (no kernel runs here, so the
    fp32 model is the reference). max |d| <= 0.05 and <= 5% of the largest
    fp32 |logit|, over every sample; argmax agreement >= 0.98 over the
    samples whose fp32 top-2 margin is above the noise floor 2 max |d|.
    Unlike ``argmax_check`` it does not ask for half the samples above
    the floor: a random-weight tower gives i.i.d. noise images nearly the
    same pooled feature (the global pool averages the noise out), so every
    sample's margin is the classifier bias's, and for some towers (the
    first chip run: ResNet-152, 0 of 32) it lies under the floor; the
    relative bar is what holds such a tower. The count above the floor and
    the agreement over every sample are reported beside it."""
    d = float((l16 - l32).abs().max())
    top2 = l32.topk(2, dim=-1).values
    keep = (top2[:, 0] - top2[:, 1]) > 2.0 * d
    n, kept = len(l32), int(keep.sum())
    agree = lambda m: float((l16[m].argmax(-1) == l32[m].argmax(-1))
                            .float().mean()) if int(m.sum()) else None
    out = {"max_logit_diff": d, "noise_floor": 2.0 * d,
           "agreement": agree(keep), "agreement_all": agree(keep | ~keep),
           "samples": n, "excluded": n - kept,
           "max_abs_logit": float(l32.abs().max())}
    ok = (d <= 0.05 and d <= 0.05 * out["max_abs_logit"]
          and (kept == 0 or out["agreement"] >= 0.98))
    return ok, out


def _conv_checks(name, model32, batch):
    """fp32 folded against unfolded (TF32 off) and bf16 folded against
    fp32 folded on ``batch["image"]`` (uint8 NHWC, numpy): (ok, the folded
    bf16 model, numbers). BatchNorm is folded in fp32 before the cast, as
    ``cli.test_image`` does; ConvNeXt has no BatchNorm."""
    import copy

    import torch

    from garbage_classification_rca_tpu_torch.models.registry import (
        get_image_model)
    from garbage_classification_rca_tpu_torch.nn.fold import fold_batchnorm

    eps = get_image_model(name).extras.get("bn_eps")
    torch.backends.cudnn.allow_tf32 = False
    unfolded = _image_logits(model32, batch, torch.float32)
    folded = model32
    if eps is not None:
        folded = fold_batchnorm(copy.deepcopy(model32), eps)
    l32 = _image_logits(folded, batch, torch.float32)
    torch.backends.cudnn.allow_tf32 = True
    model16 = folded.to(torch.bfloat16)
    l16 = _image_logits(model16, batch, torch.bfloat16)
    d_fold = float((l32 - unfolded).abs().max())
    same = bool((l32.argmax(-1) == unfolded.argmax(-1)).all())
    good16, nums = bf16_vs_fp32(l16, l32)
    fin = bool(torch.isfinite(l16).all() and torch.isfinite(l32).all())
    n = len(batch["image"])
    ok = (fin and good16 and d_fold <= 1e-4 and same
          and tuple(l16.shape) == (n, 4))
    nums.update(fold_max_logit_diff=d_fold, fold_argmax_equal=same,
                folded=eps is not None)
    print(f"  {name}: fp32 folded vs unfolded max|d|={d_fold:.3e}, argmax "
          f"equal={same}{'' if eps is not None else ' (no BatchNorm)'}; "
          f"bf16 vs fp32 max|d|={nums['max_logit_diff']:.3e} (max|logit| "
          f"{nums['max_abs_logit']:.3f}), argmax agreement "
          f"{nums['agreement']} over the {n - nums['excluded']} of {n} "
          f"samples above the noise floor "
          f"{nums['noise_floor']:.3e} (over all {nums['agreement_all']:.4f})"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    return ok, model16, nums


def _timed_batch(model, batch, hw, device):
    """One eval step (normalize, forward, argmax, correct count) on a
    uint8 batch already on the device: ms, the median of 3 after a
    warm-up (``time_ms_eager``)."""
    import torch

    from garbage_classification_rca_tpu_torch.eval.harness import (
        make_eval_step)

    g = torch.Generator(device=device).manual_seed(SEED + 160)
    b = {"image": torch.randint(0, 256, (batch, *hw, 3), dtype=torch.uint8,
                                device=device, generator=g),
         "label": torch.zeros(batch, dtype=torch.int32, device=device),
         "valid": torch.ones(batch, dtype=torch.int32, device=device)}
    step = make_eval_step(model, torch.bfloat16)
    with torch.inference_mode():
        return time_ms_eager(lambda: step(b), reps=1, warmup=1, trials=3)[0]


def _shufflenet_eval(model, device, results):
    """ShuffleNetV2 x2.0 in bf16, BN folded, through ``run_image_eval``
    over CONV_BATCHES synthetic batches of its eval batch at 224x224:
    a warm-up, the measured run with the counters zeroed before and read
    after (every hand-written kernel: 0), two more runs, a profile of one
    batch, the same three runs with ``cudnn.benchmark`` on (the phase
    leaves it off), and one timed batch of SHUFFLE_BENCH_BATCH."""
    import torch

    from garbage_classification_rca_tpu_torch.config import IMAGE_ARCHS
    from garbage_classification_rca_tpu_torch.eval.harness import (
        make_eval_step, run_image_eval)

    spec = IMAGE_ARCHS["shuffle_net"]
    data = SyntheticEvalBatcher(CONV_BATCHES, spec.eval_batch, SEED + 150,
                                image_size=spec.input_size[0])

    def run():
        return run_image_eval(model, data, spec.eval_batch, device,
                              torch.bfloat16, progress=False)

    def three():
        st = [run()[3] for _ in range(3)]
        return ([x["samples_per_s"] for x in st],
                [x["p50_step_s"] * 1e3 for x in st])

    run()                                             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _zero_counters()
    acc, labels, preds, stats = run()
    torch.cuda.synchronize()
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated(device)
    n = CONV_BATCHES * spec.eval_batch
    ok = launches == _want_launches() and len(preds) == n
    results["conv_eval_launches"] = launches
    rates, p50s = three()
    rates.append(stats["samples_per_s"])
    p50s.append(stats["p50_step_s"] * 1e3)
    h, w = spec.input_size
    print(f"  shuffle_net run_image_eval x4 over {CONV_BATCHES} batches of "
          f"{spec.eval_batch} ({h}x{w}, bf16, BN folded): samples/s "
          f"{sorted(rates)}, p50 batch ms {sorted(p50s)} (the p50 includes "
          f"the prediction readback); peak memory {peak / 2**30:.2f} GiB; "
          f"launches of the hand-written kernels "
          f"{ {k: v for k, v in launches.items() if v} } (want none)",
          flush=True)
    prof = profile_step(make_eval_step(model, torch.bfloat16),
                        data.batches[0], device, kind=_conv_kind)
    torch.backends.cudnn.benchmark = True
    try:
        run()                                         # the autotuning run
        rates_b, p50s_b = three()
    finally:
        torch.backends.cudnn.benchmark = False
    print(f"  the same with cudnn.benchmark on: samples/s {sorted(rates_b)}"
          f", p50 batch ms {sorted(p50s_b)}", flush=True)
    ms512 = _timed_batch(model, SHUFFLE_BENCH_BATCH, spec.input_size, device)
    print(f"  one batch of {SHUFFLE_BENCH_BATCH}: {ms512:.2f} ms "
          f"({SHUFFLE_BENCH_BATCH / ms512 * 1e3:.1f} samples/s)", flush=True)
    results["conv_eval_shuffle_net"] = {
        "samples_per_s": sorted(rates)[len(rates) // 2],
        "samples_per_s_runs": rates, "p50_batch_ms": sorted(p50s)[
            len(p50s) // 2], "p50_batch_ms_runs": p50s,
        "peak_mem_gib": peak / 2**30, "batches": CONV_BATCHES,
        "batch": spec.eval_batch, "profile": prof,
        "cudnn_benchmark": {"samples_per_s_runs": rates_b,
                            "p50_batch_ms_runs": p50s_b},
        "batch_512_ms": ms512}
    return ok


def check_conv_eval(device, results):
    """The 12 conv backbones at full width, random seeded weights: each
    model's fp32 / bf16 checks (``_conv_checks``) on CONV_CHECK samples at
    its ``IMAGE_ARCHS`` input size, then ShuffleNetV2 x2.0's eval run
    (``_shufflenet_eval``), and for the other 11 one timed batch at their
    ``IMAGE_ARCHS`` eval batch and input size."""
    import numpy as np
    import torch

    from garbage_classification_rca_tpu_torch.config import IMAGE_ARCHS

    ok, out = True, {}
    t0 = time.perf_counter()
    for i, name in enumerate(CONV_NAMES):
        spec = IMAGE_ARCHS[name]
        images = np.random.default_rng(SEED + 120 + i).integers(
            0, 256, (CONV_CHECK, *spec.input_size, 3), dtype=np.uint8)
        good, model, nums = _conv_checks(
            name, _conv_model(name, SEED + 100 + 2 * i, device),
            {"image": images})
        if name == "shuffle_net":
            good &= _shufflenet_eval(model, device, results)
        else:
            ms = _timed_batch(model, spec.eval_batch, spec.input_size, device)
            nums.update(batch=spec.eval_batch, input_size=spec.input_size,
                        batch_ms=ms, samples_per_s=spec.eval_batch / ms * 1e3)
            print(f"  {name}: one batch of {spec.eval_batch} at "
                  f"{spec.input_size[0]}x{spec.input_size[1]}: {ms:.2f} ms "
                  f"({nums['samples_per_s']:.1f} samples/s)", flush=True)
        out[name] = nums
        ok &= good
        del model
        torch.cuda.empty_cache()
    results["conv_eval"] = out
    print(f"  phase 10's models in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return ok


def check_conv_cli(device, results):
    """``cli.test_image --image_model=shuffle_net`` on a reference-layout
    (torchvision) ``.pth`` written from a random port model and a
    synthetic 32-image JPEG tree: ``evaluate()`` (two batches of 16, no
    hand-written kernel launched), then ``main()`` end to end
    (``drive_eval_main``)."""
    import os
    import shutil

    import torch

    from garbage_classification_rca_tpu_torch.cli import test_image
    from garbage_classification_rca_tpu_torch.config import args_parser

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_conv_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cwd = os.getcwd()
    try:
        _write_jpeg_tree(os.path.join(work, "garbage"), 0, 32, SEED + 170,
                         size=224)
        model = _conv_model("shuffle_net", SEED + 171, "cpu")
        ckpt = os.path.join(work, "shuffle_net.pth")
        torch.save(_reference_state_dict(model, "shuffle_net"), ckpt)
        del model
        argv = ["--image_model=shuffle_net", f"--model_path={ckpt}",
                "--dataset_folder_name=garbage_Val", "--eval_batch_size=16"]
        os.chdir(work)
        _zero_counters()
        t0 = time.perf_counter()
        acc, labels, preds = test_image.evaluate(args_parser(argv))[:3]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _read_counters()
        main_ok, report = drive_eval_main(test_image, argv, acc)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    good = (launches == _want_launches() and len(preds) == 32
            and 0.0 <= acc <= 100.0 and main_ok
            and sorted(set(labels.tolist())) == [0, 1, 2, 3])
    print(f"  cli.test_image --image_model=shuffle_net on 32 JPEGs in "
          f"{secs:.1f} s: accuracy {acc:.2f} %, launches "
          f"{ {k: v for k, v in launches.items() if v} } (want none) "
          f"{'ok' if good else 'FAIL'}", flush=True)
    results["conv_cli"] = {"seconds": secs, "acc": acc, "report": report,
                           "ok": good}
    return good


# ---------------------------------------------------------------------------
# phase 11: the late-fusion family's eval path (the six other heads; the
# BERT and BART-large fusion towers)
# ---------------------------------------------------------------------------

FUSION_BATCH, FUSION_BATCHES = 128, 2   # the eval batch; DistilBERT runs
FUSION_CLIP_BATCH = 16                  # --batch_size: CLIP's eval batch
# (tower, strategy, batches): DistilBERT over 2 batches, BERT and BART one
# timed batch; CLIP at FUSION_CLIP_BATCH, every other at FUSION_BATCH
FUSION_RUNS = tuple(
    [("distilbert", s, FUSION_BATCHES) for s in (
        "gated", "classic", "normalized", "hierarchical", "bimodal", "clip")]
    + [("bert", s, 1) for s in ("gated", "MM_RCA", "hierarchical")]
    + [("bart", s, 1) for s in ("classic", "clip")])
# K2 launches a batch: one a tower layer (BART runs no kernel)
FUSION_K2 = {"distilbert": 6, "bert": 12, "bart": 0}
_BART_ATTN = {"self": "self_attn", "cross": "encoder_attn"}
_BART_PROJ = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "out": "out_proj"}
_BART_SUB = {"ln_self": "self_attn_layer_norm",
             "ln_cross": "encoder_attn_layer_norm", "fc1": "fc1",
             "fc2": "fc2", "ln_final": "final_layer_norm"}


def _bart_key(parts):
    """A port BartClassifier parameter -> its
    ``BartForSequenceClassification`` key."""
    leaf = _LEAF[parts[-1]]
    head = {"head_dense": "dense", "head_out": "out_proj"}
    if parts[0] in head:
        return f"classification_head.{head[parts[0]]}.{leaf}"
    if parts[0] == "shared":
        return "model.shared.weight"
    stack = "encoder" if parts[0].startswith("enc") else "decoder"
    if parts[0].endswith("_pos"):
        return f"model.{stack}.embed_positions.weight"
    if parts[0].endswith("_ln_emb"):
        return f"model.{stack}.layernorm_embedding.{leaf}"
    pre = f"model.{stack}.layers.{parts[1]}."
    if parts[2] in _BART_ATTN:
        return pre + f"{_BART_ATTN[parts[2]]}.{_BART_PROJ[parts[3]]}.{leaf}"
    return pre + f"{_BART_SUB[parts[2]]}.{leaf}"


def _fusion_towers(device):
    """The towers the runs share, on the card in fp32: EfficientNetV2-M
    (random BN statistics, folded) and DistilBERT (6 layers), BERT-base
    (12) and BART-large (12 + 12, vocabulary 50,265; built as the
    classifier, whose head the tower does not read, so that phase 11's
    ``cli.test_text`` drive saves the same weights), random weights from
    seeds."""
    import torch

    from garbage_classification_rca_tpu_torch.models.fusion import multimodal
    from garbage_classification_rca_tpu_torch.models.image import (
        efficientnet_common as eff, efficientnet_v2 as effv2)
    from garbage_classification_rca_tpu_torch.models.text import bart
    from garbage_classification_rca_tpu_torch.nn.fold import fold_batchnorm

    gen = lambda s: torch.Generator().manual_seed(s)
    image = eff.EffNet(effv2.CONFIGS["eff_v2_medium"],
                       generator=gen(SEED + 200)).to(device).eval()
    _randomize_bn(image, torch.Generator(device=device).manual_seed(
        SEED + 201))
    fold_batchnorm(image, 1e-3)
    towers = {"image": image, "bart": bart.BartClassifier(
        generator=gen(SEED + 202)).to(device).eval()}
    for i, name in enumerate(("distilbert", "bert")):
        towers[name] = multimodal.TEXT_TOWERS[name](
            generator=gen(SEED + 203 + i)).to(device).eval()
    return towers


def _fusion_heads(cfg, seed):
    """A FusionModel of `cfg` with its heads drawn from `seed` and no
    towers (``text`` and ``image`` None), for the caller to give it towers
    built once for every head: it is built on a one-stage stand-in image
    tower and no text layer."""
    import torch

    from garbage_classification_rca_tpu_torch.models.fusion import multimodal
    from garbage_classification_rca_tpu_torch.models.image import (
        efficientnet_common as eff, efficientnet_v2 as effv2)

    stub = eff.EffNetConfig(stages=(("fused", 1, 3, 1, 8, 8, 1),),
                            stem_out=8, head_out=multimodal.IMG_FEAT,
                            bn_eps=1e-3)
    model = multimodal.FusionModel(
        cfg, text_layers=0, image_cfg=stub,
        generator=torch.Generator().manual_seed(seed))
    model.text = model.image = None
    model.image_cfg = effv2.CONFIGS["eff_v2_medium"]
    return model


def _fusion_pair(cfg, towers32, towers16, seed, device):
    """(fp32, bf16) FusionModels of `cfg` on the card: the same heads, the
    shared towers of each dtype."""
    import copy

    import torch

    m32 = _fusion_heads(cfg, seed).to(device).eval()
    m16 = copy.deepcopy(m32).to(torch.bfloat16)
    for m, towers in ((m32, towers32), (m16, towers16)):
        m.text, m.image = towers[cfg.text_model_name], towers["image"]
    return m32, m16


def _sliced(data, n, batches=None):
    """The first `batches` (all) of `data`'s batches, each cut to its
    first `n` samples."""
    out = SyntheticBatcher.__new__(SyntheticBatcher)
    out.batches = [{k: v[:n] for k, v in b.items()}
                   for b in data.batches[:batches]]
    out.m = list(range(n * len(out.batches)))
    return out


def fusion_agreement(lk, lp, truth):
    """The bf16 check of phase 11's kernel path `lk` against its plain path
    `lp` on one batch, `truth` the fp32 model's plain logits: max |d| <=
    0.05 over every sample, and argmax agreement >= 0.98 over the samples
    whose fp32 top-2 margin is above the noise floor 2 max |lp - truth|
    (``argmax_check``'s floor). Unlike ``argmax_check`` it does not ask for
    half the samples above the floor: the i.i.d. noise images give every
    sample nearly one pooled image feature (``bf16_vs_fp32`` says why), so
    a random head's margins may all be small; the count above the floor
    and the agreement over all samples are reported beside it."""
    d = float((lk - lp).abs().max())
    floor = 2.0 * float((lp - truth).abs().max())
    top2 = truth.topk(2, dim=-1).values
    keep = (top2[:, 0] - top2[:, 1]) > floor
    agree = lambda m: float((lk[m].argmax(-1) == lp[m].argmax(-1))
                            .float().mean()) if int(m.sum()) else None
    out = {"max_logit_diff": d, "noise_floor": floor,
           "agreement": agree(keep), "agreement_all": agree(keep | ~keep),
           "samples": len(truth), "excluded": len(truth) - int(keep.sum()),
           "bf16_vs_fp32": float((lk - truth).abs().max())}
    ok = d <= 0.05 and (out["agreement"] is None or out["agreement"] >= 0.98)
    return ok, out


def fusion_split(model, batch):
    """One bf16 batch's forward (normalized images and ids already on the
    card) split by CUDA events recorded around the towers (``_towers``)
    and around each bimodal GRU scan: towers / head / GRU ms of the
    device's timeline (a span includes the time the device waits for the
    host inside it), and for bimodal the scan's kernel launches and device
    time from the profiler over the three GRU calls on their inputs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from garbage_classification_rca_tpu_torch.models.fusion import multimodal
    from garbage_classification_rca_tpu_torch.nn import core

    marks = {"towers": [], "gru": []}
    inputs = []
    real_towers, real_gru = multimodal._towers, core.GRU.forward

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def towers(*a, **kw):
        start = event()
        out = real_towers(*a, **kw)
        marks["towers"].append((start, event()))
        return out

    def gru(self, x):
        start = event()
        out = real_gru(self, x)
        marks["gru"].append((start, event()))
        inputs.append((self, x))
        return out

    ids, mask, x = batch
    with torch.inference_mode():
        model(ids, mask, x)                                 # warm-up
        multimodal._towers, core.GRU.forward = towers, gru
        try:
            start = event()
            model(ids, mask, x)
            end = event()
        finally:
            multimodal._towers, core.GRU.forward = real_towers, real_gru
        torch.cuda.synchronize()
        span = lambda key: sum(a.elapsed_time(b) for a, b in marks[key])
        out = {"batch_ms": start.elapsed_time(end), "towers_ms": span("towers"),
               "gru_ms": span("gru")}
        out["head_ms"] = out["batch_ms"] - out["towers_ms"]
        if inputs:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for mod, xi in inputs:
                    mod(xi)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            dev = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
            out.update(
                gru_launches=sum(e.count for e in dev),
                gru_device_ms=sum(getattr(e, "self_device_time_total", 0.0)
                                  for e in dev) / 1e3,
                gru_wall_ms=wall * 1e3, gru_steps=sum(
                    xi.shape[0] for _, xi in inputs))
    return out


def _kernel_less_check(m32, m16, strategy, batch, lk, truth, device):
    """The bf16 check of a run with no kernel (the BART tower): the bf16
    model's logits `lk` against the fp32 model's `truth` by
    ``bf16_vs_fp32``'s bars. Beside it, recorded and not judged, the bf16
    towers' features through the fp32 head against `truth`: the towers'
    own bf16 error as the head reads it. The CLIP head is held to |d| <=
    0.05 and the argmax agreement, without the relative bar: it
    L2-normalizes both features and multiplies their dot products by
    exp(logit_scale) = 14.3, so it magnifies the towers' bf16 error while
    its random-weight logits stay small (on an H100 80GB HBM3 at 700 W:
    5.6% of the largest |logit| 0.23, and 6.0% through the fp32 head, so
    not the head's own rounding), where the classic head over the same
    BART tower reads 2.1%."""
    import torch

    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)
    from garbage_classification_rca_tpu_torch.models.fusion import multimodal

    good, agr = bf16_vs_fp32(lk, truth)
    cfg = m32.cfg
    with torch.inference_mode():
        dev = {k: torch.from_numpy(batch[k]).to(device)
               for k in ("input_ids", "attention_mask", "image")}
        x = normalize_on_device(dev["image"], dtype=torch.bfloat16)
        text, hid, s3, s6, img = multimodal._towers(
            cfg, m16, x, dev["input_ids"], dev["attention_mask"],
            need_hiddens=strategy == "hierarchical")
        up = lambda t: None if t is None else t.float()
        lt = multimodal._HEADS[strategy](
            cfg, m32, up(text), up(img), hiddens=hid and [up(h) for h in hid],
            s3=up(s3), s6=up(s6)).float()
    agr["towers"] = bf16_vs_fp32(lt, truth)[1]
    if strategy == "clip":
        good = agr["max_logit_diff"] <= 0.05 and (
            agr["agreement"] is None or agr["agreement"] >= 0.98)
    return good, agr


def _fusion_run(tower, strategy, n_batches, pair, data, device,
                profile=True):
    """One (tower, strategy) run; returns (ok, numbers, launches).
    `profile`: the device profile of a batch (each tower's first run)."""
    import torch

    from garbage_classification_rca_tpu_torch.cli.test_both import (
        make_both_eval_step, run_multimodal_eval)
    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)

    m32, m16 = pair
    batch_size = len(data.batches[0]["label"])
    first = data.batches[0]
    ok, nums = True, {"batch": batch_size, "batches": n_batches}
    torch.backends.cudnn.allow_tf32 = False
    if FUSION_K2[tower]:
        # fp32, TF32 off, 16 samples: kernel path (K2 on the CUDA cores)
        # against plain path
        small = {k: v[:16] for k, v in first.items()}
        _zero_counters()
        lk = _logits(m32, small, torch.float32, device)
        ran = _read_counters() == _want_launches(
            mha=FUSION_K2[tower], rca_fused=int(strategy == "MM_RCA"))
        with plain_versions():
            lp = _logits(m32, small, torch.float32, device)
        d32 = float((lk - lp).abs().max())
        ok &= (ran and d32 <= 1e-4
               and bool((lk.argmax(-1) == lp.argmax(-1)).all())
               and bool(torch.isfinite(lk).all()))
        nums["fp32_max_logit_diff"] = d32
    with plain_versions():
        truth = _logits(m32, first, torch.float32, device)
    torch.backends.cudnn.allow_tf32 = True

    run = lambda: run_multimodal_eval(m16, data, batch_size, device,
                                      torch.bfloat16, progress=False)
    run()                                                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _zero_counters()
    _, _, preds, stats = run()
    torch.cuda.synchronize()
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated(device)
    want = _want_launches(
        mha_tc=FUSION_K2[tower] * n_batches,
        rca_fused=n_batches if strategy == "MM_RCA" else 0)
    ok &= launches == want and len(preds) == n_batches * batch_size
    prof = (profile_step(make_both_eval_step(m16, torch.bfloat16), first,
                         device, reps=2) if profile else
            {"device_ms_per_batch": None, "idle_share": None})
    lk = _logits(m16, first, torch.bfloat16, device)
    ok &= bool(torch.isfinite(lk).all()) and tuple(lk.shape) == (
        batch_size, 4)
    if FUSION_K2[tower]:
        with plain_versions():
            lp = _logits(m16, first, torch.bfloat16, device)
        good, agr = fusion_agreement(lk, lp, truth)
    else:
        good, agr = _kernel_less_check(m32, m16, strategy, first, lk, truth,
                                       device)
    ok &= good
    with torch.inference_mode():
        dev = {k: torch.from_numpy(first[k]).to(device)
               for k in ("input_ids", "attention_mask", "image")}
        split = fusion_split(m16, (dev["input_ids"], dev["attention_mask"],
                                   normalize_on_device(dev["image"],
                                                       dtype=torch.bfloat16)))
    nums.update(samples_per_s=stats["samples_per_s"],
                p50_batch_ms=stats["p50_step_s"] * 1e3,
                device_ms_per_batch=prof["device_ms_per_batch"],
                idle_share=prof["idle_share"], peak_mem_gib=peak / 2**30,
                split=split, agreement=agr,
                launches={k: v for k, v in launches.items() if v})
    gru = (f", GRU scan {split['gru_steps']} steps: {split['gru_launches']} "
           f"launches, device {split['gru_device_ms']:.2f} ms, wall "
           f"{split['gru_wall_ms']:.2f} ms" if "gru_launches" in split
           else "")
    check = (f"kernel vs plain max|d|={agr['max_logit_diff']:.3e}, "
             f"agreement {agr['agreement']} above the floor "
             f"{agr['noise_floor']:.3e} ({agr['samples'] - agr['excluded']} "
             f"of {agr['samples']}; all {agr['agreement_all']:.4f}), bf16 vs "
             f"fp32 max|d|={agr['bf16_vs_fp32']:.3e}, fp32 kernel vs plain "
             f"max|d|={nums['fp32_max_logit_diff']:.3e}"
             if FUSION_K2[tower] else
             f"no kernel; bf16 vs fp32 max|d|={agr['max_logit_diff']:.3e} "
             f"(max|logit| {agr['max_abs_logit']:.3e}), agreement "
             f"{agr['agreement']} above the floor ({agr['samples'] - agr['excluded']}"
             f" of {agr['samples']}; all {agr['agreement_all']:.4f}); the "
             f"bf16 towers through the fp32 head: max|d|="
             f"{agr['towers']['max_logit_diff']:.3e}, agreement "
             f"{agr['towers']['agreement']}")
    print(f"  {strategy} + {tower}: {n_batches} x {batch_size}: "
          f"{stats['samples_per_s']:.1f} samples/s, p50 "
          f"{nums['p50_batch_ms']:.2f} ms, device "
          f"{prof['device_ms_per_batch'] or float('nan'):.2f} ms a batch, peak "
          f"{peak / 2**30:.2f} GiB; launches {nums['launches']} (want "
          f"{ {k: v for k, v in want.items() if v} }); split of one batch: "
          f"towers {split['towers_ms']:.2f} ms, head {split['head_ms']:.2f} "
          f"ms{gru}; {check} {'ok' if ok else 'FAIL'}", flush=True)
    return ok, nums, launches


def check_fusion_eval(device, results):
    """The seven late-fusion heads at full width with random seeded
    weights (``FUSION_RUNS``): each run's fp32 check, its bf16
    ``run_multimodal_eval`` with the counters zeroed before and read after
    (K2 6 a DistilBERT batch, 12 a BERT batch, 0 with BART; K1 on the BERT
    MM-RCA run), a profile (each tower's first run), the kernel path against the plain path (BART:
    bf16 against fp32) and the towers / head split; the counts summed over
    the runs are the ``fusion_eval`` path's."""
    import copy

    import torch

    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        get_tokenizer)
    from garbage_classification_rca_tpu_torch.models.fusion import multimodal

    t0 = time.perf_counter()
    towers32 = _fusion_towers(device)
    towers16 = {k: copy.deepcopy(v).to(torch.bfloat16)
                for k, v in towers32.items()}
    toks = {name: get_tokenizer(name, vocab_dir=f"tests/fixtures/vocab/{v}")
            for name, v in (("distilbert", "wordpiece"), ("bart", "bpe"))}
    data = {"distilbert": SyntheticBatcher(
        FUSION_BATCHES * FUSION_BATCH, FUSION_BATCH, (480, 480),
        toks["distilbert"], 64, SEED + 210)}
    data["bert"] = _sliced(data["distilbert"], FUSION_BATCH, 1)
    data["bart"] = SyntheticBatcher(FUSION_BATCH, FUSION_BATCH, (480, 480),
                                    toks["bart"], 64, SEED + 211)
    print(f"  towers and data in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ok, out, total = True, {}, {}
    for i, (tower, strategy, n) in enumerate(FUSION_RUNS):
        cfg = multimodal.FusionConfig(strategy=strategy,
                                      text_model_name=tower, reverse=True,
                                      batch_size=FUSION_CLIP_BATCH)
        run_data = data[tower]
        if strategy == "clip":
            run_data = _sliced(run_data, FUSION_CLIP_BATCH)
        pair = _fusion_pair(cfg, towers32, towers16, SEED + 220 + i, device)
        good, nums, launches = _fusion_run(
            tower, strategy, n, pair, run_data, device,
            profile=all(t != tower for t, _, _ in FUSION_RUNS[:i]))
        ok &= good
        out[f"{strategy}_{tower}"] = nums
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        del pair
        torch.cuda.empty_cache()
    results["fusion_eval"] = out
    results["fusion_eval_launches"] = total
    print(f"  fusion_eval launches over the {len(FUSION_RUNS)} runs: "
          f"{ {k: v for k, v in total.items() if v} }; phase 11's runs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    results["fusion_bart"] = towers32["bart"]
    return ok


def check_fusion_clis(device, results):
    """``cli.test_both`` with the default --late_fusion (gated) and with
    --late_fusion=clip on BEST checkpoints written from random unfolded
    port models (DistilBERT tower), over a synthetic 32-image 480x480 JPEG
    tree: ``evaluate()`` with its launches (K2 6 a batch: one batch of 32
    for gated, two of 16 for clip) and ``main()`` end to end; then
    ``cli.test_text --text_model=bart`` ``evaluate()`` on a
    ``BartForSequenceClassification``-layout ``.pth`` of phase 11's
    BART-large (no kernel launched)."""
    import os
    import shutil

    import torch

    from garbage_classification_rca_tpu_torch.cli import test_both, test_text
    from garbage_classification_rca_tpu_torch.config import args_parser
    from garbage_classification_rca_tpu_torch.models.fusion import multimodal
    from garbage_classification_rca_tpu_torch.train.engine import save_best

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_fusion_clis")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    vocab = os.path.join(here, "tests", "fixtures", "vocab")
    bart = results.pop("fusion_bart")
    cwd = os.getcwd()
    ok, out = True, {}
    try:
        _write_jpeg_tree(os.path.join(work, "garbage"), 0, 32, SEED + 230)
        os.chdir(work)
        gated = multimodal.FusionModel(
            multimodal.FusionConfig(strategy="gated"),
            generator=torch.Generator().manual_seed(SEED + 231))
        clip = _fusion_heads(multimodal.FusionConfig(strategy="clip"),
                             SEED + 232)
        clip.text, clip.image = gated.text, gated.image
        for flags, model, batches in (([], gated, 1),
                                      (["--late_fusion=clip"], clip, 2)):
            name = flags[0].split("=")[1] if flags else "gated (default)"
            path = save_best(model, model_name=name.split()[0], epoch=0,
                             val_acc=0.0, args=args_parser([]),
                             fine_tuning=False)
            argv = flags + [f"--model_path={path}",
                            "--dataset_folder_name=garbage_Val",
                            f"--vocab_dir={vocab}/wordpiece"]
            _zero_counters()
            t0 = time.perf_counter()
            acc, labels, preds, _ = test_both.evaluate(args_parser(argv))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = _read_counters()
            main_ok, report = drive_eval_main(test_both, argv, acc)
            good = (launches == _want_launches(mha_tc=6 * batches)
                    and len(preds) == 32 and main_ok
                    and sorted(set(labels.tolist())) == [0, 1, 2, 3])
            print(f"  cli.test_both {name} on 32 JPEGs in {secs:.1f} s: "
                  f"accuracy {acc:.2f} %, launches "
                  f"{ {k: v for k, v in launches.items() if v} } "
                  f"{'ok' if good else 'FAIL'}", flush=True)
            out[f"test_both_{name.split()[0]}"] = {
                "seconds": secs, "acc": acc, "report": report, "ok": good}
            ok &= good
        del gated, clip
        ckpt = os.path.join(work, "bart.pth")
        t0 = time.perf_counter()
        torch.save(_reference_state_dict(bart, "bart"), ckpt)
        depth = len(bart.enc_layers)
        del bart
        save_s = time.perf_counter() - t0
        _zero_counters()
        t0 = time.perf_counter()
        acc, labels, preds = test_text.evaluate(args_parser([
            "--text_model=bart", f"--model_path={ckpt}",
            "--dataset_folder_name=garbage_Val",
            f"--vocab_dir={vocab}/bpe"]))[:3]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _read_counters()
        good = (launches == _want_launches() and len(preds) == 32
                and 0.0 <= acc <= 100.0
                and sorted(set(labels.tolist())) == [0, 1, 2, 3])
        print(f"  cli.test_text --text_model=bart ({depth} + {depth} "
              f"layers) on 32 "
              f"samples in {secs:.1f} s (the .pth written in {save_s:.1f} "
              f"s): accuracy {acc:.2f} %, launches "
              f"{ {k: v for k, v in launches.items() if v} } (want none) "
              f"{'ok' if good else 'FAIL'}", flush=True)
        out["test_text_bart"] = {"seconds": secs, "save_s": save_s,
                                 "acc": acc, "ok": good}
        ok &= good
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    results["fusion_clis"] = out
    return ok


# ---------------------------------------------------------------------------
# phase 12: the VLM eval path (BLIP-2 / Q-Former: EVA ViT-g, Q-Former,
# OPT-2.7B; K2 at head dims 88 and 80)
# ---------------------------------------------------------------------------

VLM_BATCH = 16          # cli.blip2_test / cli.qformer_test's --eval_batch_size
VLM_BENCH_BATCH = 8     # bench.py bench_blip2's batch
VLM_BATCHES = 4         # timed batches of VLM_BATCH (8 of VLM_BENCH_BATCH)
VLM_K2 = {"blip2": 71, "qformer": 39}   # K2 a batch: 39 EVA + 32 OPT layers
VLM_CLASSES = ("black", "blue", "green", "ttr")
VLM_ITEMS = ("coffee cup", "water bottle", "banana peel", "battery pack",
             "greasy pizza box", "glass jar", "paint can", "old phone",
             "newspaper", "apple core", "styrofoam plate", "tin can")


class SyntheticVLMBatcher:
    """``cli.blip2_common.Blip2Batcher`` stand-in: seeded uint8 224x224
    images and the knowledge prompt around random item words, tokenized
    by the OPT hash tokenizer and left-padded to 100, all made before the
    run; ``batches(size)`` cuts the same samples into batches of `size`."""

    def __init__(self, n, tokenizer, seed):
        import numpy as np

        from garbage_classification_rca_tpu_torch.cli.blip2_common import (
            left_pad)
        from garbage_classification_rca_tpu_torch.models.vlm.prompts import (
            MAX_PROMPT_TOKENS, build_prompt)

        rng = np.random.default_rng(seed)
        self.m = list(range(n))
        rows = [left_pad(tokenizer.encode_one(build_prompt(" ".join(
            rng.choice(VLM_ITEMS, rng.integers(1, 4)))),
            MAX_PROMPT_TOKENS)[0], MAX_PROMPT_TOKENS, tokenizer.pad_id)
            for _ in range(n)]
        self.samples = {
            "image": rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8),
            "input_ids": np.asarray([r[0] for r in rows], np.int32),
            "attention_mask": np.asarray([r[1] for r in rows], np.int32),
            "label": rng.integers(0, 4, n).astype(np.int32),
            "valid": np.ones(n, np.int32)}

    def batch(self, start, size):
        return {k: v[start:start + size] for k, v in self.samples.items()}

    def iter_batches(self, batch_size, *, shuffle=False, **_):
        assert not shuffle and len(self.m) % batch_size == 0
        for start in range(0, len(self.m), batch_size):
            yield self.batch(start, batch_size)


def _vlm_answer_tokens(tok):
    """``answer_first_token_table`` of the four classes under `tok`."""
    import types

    from garbage_classification_rca_tpu_torch.cli.blip2_train import (
        answer_first_token_table)
    from garbage_classification_rca_tpu_torch.models.vlm.prompts import (
        FOLDER_TO_ANSWER)

    stub = types.SimpleNamespace(answer_token_ids={
        c: tok.encode_one(FOLDER_TO_ANSWER[c], 4)[0] for c in VLM_CLASSES})
    return answer_first_token_table(stub, VLM_CLASSES)


def _vlm_step(what, model, aft, dtype):
    from garbage_classification_rca_tpu_torch.cli import blip2_train
    from garbage_classification_rca_tpu_torch.cli import qformer_train

    if what == "blip2":
        return blip2_train.make_eval_step(model, aft, dtype)
    return qformer_train.make_eval_step(model, dtype)


def _vlm_logits(what, model, batch, aft, dtype, device):
    """fp32 [B, 4] class logits of one host batch: the four answer tokens'
    next-token logits (blip2), the classifier's (qformer)."""
    import torch

    from garbage_classification_rca_tpu_torch.cli.blip2_common import (
        normalize_clip)
    from garbage_classification_rca_tpu_torch.models.vlm import blip2

    with torch.inference_mode():
        dev = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        x = normalize_clip(dev["image"], dtype)
        if what == "qformer":
            return model.classifier(
                blip2.qformer_cls_feature(model, x).float()).float()
        out = blip2.next_token_logits(model, x, dev["input_ids"],
                                      dev["attention_mask"])
        return out.float()[:, torch.as_tensor(aft, device=device).long()]


def vlm_split(model, batch, device):
    """One bf16 BLIP-2 batch's ``next_token_logits`` split by CUDA events
    that forward hooks record around the EVA tower and the Q-Former: EVA,
    Q-Former, and the rest (projection, OPT decoder, lm head), in ms of
    the device's timeline, after a warm-up call."""
    import torch

    from garbage_classification_rca_tpu_torch.cli.blip2_common import (
        normalize_clip)
    from garbage_classification_rca_tpu_torch.models.vlm import blip2

    ev = {}

    def mark(name):
        def hook(*_):
            ev[name] = torch.cuda.Event(enable_timing=True)
            ev[name].record()
        return hook

    hooks = [model.vision.register_forward_pre_hook(mark("start")),
             model.vision.register_forward_hook(mark("eva")),
             model.qformer.register_forward_hook(mark("qformer"))]
    try:
        with torch.inference_mode():
            dev = {k: torch.from_numpy(v).to(device)
                   for k, v in batch.items()}
            x = normalize_clip(dev["image"], torch.bfloat16)
            for _ in range(2):
                blip2.next_token_logits(model, x, dev["input_ids"],
                                        dev["attention_mask"])
                mark("end")()
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return {"eva_ms": ev["start"].elapsed_time(ev["eva"]),
            "qformer_ms": ev["eva"].elapsed_time(ev["qformer"]),
            "opt_ms": ev["qformer"].elapsed_time(ev["end"])}


def _k2_flops(b, n, d, mask, causal):
    """QK^T and PV multiply-adds x 2 over the keys each query attends to:
    every key (no mask), its valid keys at or before it (causal + mask)."""
    import torch

    if not causal:
        return 4 * b * n * n * d
    m = mask.bool().cpu()
    tri = torch.ones((n, n), dtype=torch.bool).tril()
    pairs = int((tri[None] & m[:, None, :]).sum())
    return 4 * pairs * d


def _late_mask(m, n, first):
    """`m` with sample 2's first `first` keys padded: its causal rows 0 ..
    first - 1 attend no key at or before the diagonal, and the query tile
    that holds row `first` holds both kinds of rows."""
    import torch

    late = m.cpu().clone()
    late[2] = (torch.arange(n) >= first).to(torch.int32)
    return late.to(m.device)


def check_vlm_kernels(device, path_mask, results):
    """K2 at the path's two shapes, batch VLM_BATCH: the EVA tower's
    16 heads of 88 over 257 tokens unmasked (and once with a key mask
    holding a fully masked sample and one with a single valid key), the
    OPT decoder's 32 heads of 80 over 132 tokens, causal, with the path's
    mask (32 query tokens + the left-padded prompt) and with such edge
    samples. fp32 runs the CUDA cores (its one route), bf16 both routes on
    the same inputs: the CUDA cores (``route="cuda_core"``) against
    ``mha_reference`` at 1e-5 + 1e-5|x| / one ulp + 1e-3, the tensor cores
    (the default) at the one-flip bar (``_k2_held``: one ulp + one
    weight's rounding move, the count past one ulp + 1e-3 beside it),
    bit-identical over two runs, each launch on its route's counter; the
    tensor cores also at N = 1 and, for OPT, with a sample whose first 100
    keys are pads (``_late_mask``). Then the path's bf16 call on both
    routes timed new-old-old-new as phase 3 times K2 (a CUDA graph of 20
    launches, median of 5) beside the plain version, SDPA with the
    equivalent additive bias and the bound."""
    import torch
    import torch.nn.functional as F

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

    gen = torch.Generator().manual_seed(SEED + 250)
    gen_tc = torch.Generator().manual_seed(SEED + 251)
    ok_all, rows = True, []
    shapes = {"eva": (VLM_BATCH, 257, 1408, 16, False, None),
              "opt": (VLM_BATCH, 132, 2560, 32, True, path_mask)}
    for name, (b, n, d, h, causal, m) in shapes.items():
        edge = torch.ones((b, n), dtype=torch.int32)
        if m is not None:
            edge = m.cpu().clone()
        edge[0] = 0                                   # every key a pad
        edge[1] = 0
        edge[1, -1] = 1                               # one valid key
        edge = edge.to(device)
        errs, over = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((b, n, d), generator=gen).to(device, dtype)
                       for _ in range(3))
            bf16 = dtype == torch.bfloat16
            for label, mm in (("path", m), ("edge", edge)):
                plan = K.mha_plan(q.shape, h, dtype)
                c0 = dict(K.mha.route_launches)
                got = K.mha(q, k, v, heads=h, mask=mm, causal=causal,
                            route="cuda_core")
                torch.cuda.synchronize()
                want = K.mha_reference(q, k, v, heads=h, mask=mm,
                                       causal=causal)
                err, ok = max_err_ok(got, want, dtype, "mha")
                ok &= (plan.route == ("tc" if bf16 else "cuda_core")
                       and plan.bwd_route == "none")
                ok &= K.mha.route_launches == {
                    **c0, "cuda_core": c0["cuda_core"] + 1}
                ok_all &= ok
                errs[f"{str(dtype)[6:]}_{label}"] = err
                print(f"  mha cuda_core {str(dtype)[6:]:8s} {name} B={b} "
                      f"N={n} D={d} H={h} (head dim {d // h}) causal="
                      f"{causal!s:5s} mask={label}: max|d|={err:.3e} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if bf16:
                    ok_all &= _vlm_k2_tc(K, q, k, v, h, mm, causal, want,
                                         name, label, errs, over)
            if not bf16:
                continue
            # the tensor cores' own edge cases: N = 1; a late first key
            q1, k1, v1 = (torch.randn((b, 1, d), generator=gen_tc).to(
                device, dtype) for _ in range(3))
            m1 = torch.ones((b, 1), dtype=torch.int32, device=device)
            m1[0] = 0
            for label, mm, qq, kk, vv in (
                    ("N=1", m1 if causal else None, q1, k1, v1),
                    ("late", _late_mask(m, n, 100) if causal else None,
                     q, k, v)):
                if label == "late" and not causal:
                    continue
                want = K.mha_reference(qq, kk, vv, heads=h, mask=mm,
                                       causal=causal)
                ok_all &= _vlm_k2_tc(K, qq, kk, vv, h, mm, causal, want,
                                     name, label, errs, over)
        # the path's call in bf16, both routes timed
        q, k, v = (torch.randn((b, n, d), generator=gen).to(
            device, torch.bfloat16) for _ in range(3))
        run = {r: functools.partial(K.mha, q, k, v, heads=h, mask=m,
                                    causal=causal, route=r)
               for r in ("tc", "cuda_core")}
        ab = {"tc": [], "cuda_core": []}
        for route in ("tc", "cuda_core", "cuda_core", "tc"):
            ab[route].append(time_ms(run[route])[0])
        plain = time_ms(lambda: K.mha_reference(q, k, v, heads=h, mask=m,
                                                causal=causal))[0]
        allowed = torch.ones((b, n, n), dtype=torch.bool, device=device)
        if m is not None:
            allowed &= m.bool()[:, None, :]
        if causal:
            allowed &= torch.ones((n, n), dtype=torch.bool,
                                  device=device).tril()[None]
        bias = torch.where(allowed, 0.0, K.NEG).to(torch.bfloat16)[:, None]
        rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)
        library = time_ms(lambda: F.scaled_dot_product_attention(
            rs(q), rs(k), rs(v), attn_mask=bias))[0]
        flops = _k2_flops(b, n, d, m, causal)
        nbytes = 4 * q.numel() * q.element_size() + (
            m.numel() * 4 if m is not None else 0)
        bound_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        bound = max(bound_ops, bound_bytes)
        ms, cc = sum(ab["tc"]) / 2, sum(ab["cuda_core"]) / 2
        rows.append({"tower": name, "shape": [b, n, d], "heads": h,
                     "head_dim": d // h, "causal": causal,
                     "masked": m is not None, "ms": ms,
                     "ms_runs": ab["tc"], "cuda_core_ms": cc,
                     "cuda_core_ms_runs": ab["cuda_core"],
                     "plain_ms": plain, "library_ms": library,
                     "bound_ms": bound,
                     "bound_by": "operations" if bound_ops >= bound_bytes
                     else "bytes", "share_of_bound": bound / ms,
                     "cuda_core_share_of_bound": bound / cc,
                     "tflops": flops / ms / 1e9, "max_abs_err": errs,
                     "over_one_ulp_1e-3": over})
        print(f"  mha bf16 {name} {b}x{n}x{d}, {h} heads, new-old-old-new: "
              f"tc {ab['tc'][0]:.4f} / {ab['tc'][1]:.4f} ms, CUDA cores "
              f"{ab['cuda_core'][0]:.4f} / {ab['cuda_core'][1]:.4f} ms; tc "
              f"{flops / ms / 1e9:.2f} TFLOP/s; plain {plain:.4f} ms, sdpa "
              f"(additive bias) {library:.4f} ms, bound {bound:.4f} ms "
              f"({rows[-1]['bound_by']}); share of the bound tc "
              f"{bound / ms:.3f}, CUDA cores {bound / cc:.3f}; tc / sdpa "
              f"{ms / library:.2f}", flush=True)
    results["vlm_k2"] = rows
    return ok_all


def _vlm_k2_tc(K, q, k, v, h, m, causal, want, tower, label, errs, over):
    """K2's default (tensor-core) route on one case against `want`, the
    plain version's output: the one-flip bar, bit-identical over two runs,
    two launches on the "tc" counter. Records the error and the count of
    elements past one ulp + 1e-3 under `label`."""
    import torch

    c0 = dict(K.mha.route_launches)
    plan = K.mha_plan(q.shape, h, q.dtype)
    got = K.mha(q, k, v, heads=h, mask=m, causal=causal)
    again = K.mha(q, k, v, heads=h, mask=m, causal=causal)
    torch.cuda.synchronize()
    err, ok, n_over = _k2_held(got, want, q, k, v, h, m, causal, True)
    ok &= (torch.equal(got, again) and plan.route == "tc"
           and K.mha.route_launches == {**c0, "tc": c0["tc"] + 2})
    errs[f"tc_{label}"] = err
    over[f"tc_{label}"] = n_over
    b, n, d = q.shape
    print(f"  mha tc        bfloat16 {tower} B={b} N={n} D={d} H={h} (head "
          f"dim {d // h}) causal={causal!s:5s} mask={label}: max|d|="
          f"{err:.3e}, over one ulp + 1e-3: {n_over}; bit-identical over two "
          f"runs {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def check_vlm_eval(device, results):
    """Full-width, full-depth BLIP-2 (blip2-opt-2.7b) on random weights
    from fixed seeds, adapters with B != 0 and a Q-Former classifier, in
    fp32 and bf16: K2 at its two shapes (``check_vlm_kernels``); the fp32
    kernel path against the plain path (TF32 off) on one batch of
    VLM_BATCH, next-token class logits and classifier logits within 1e-4
    of the largest |logit|, with K2's launches counted (71 / 39); the bf16
    kernel path against the plain path (``fusion_agreement``, the fp32
    plain logits its truth); then BLIP-2 eval at batch 16 and 8 and the
    Q-Former eval at 16 through ``vlm_eval`` with the counters zeroed
    before and read after: samples/s, p50, peak memory, a profile (device
    ms, idle share, K2's ms) and the EVA / Q-Former / OPT split of a batch
    by CUDA events. The bf16 model is kept for the CLIs' checkpoint."""
    import copy
    import gc

    import torch

    from garbage_classification_rca_tpu_torch.cli.blip2_common import (
        blip2_config, vlm_eval)
    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        get_tokenizer)
    from garbage_classification_rca_tpu_torch.models.vlm import blip2

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  device memory held at the start: "
          f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB",
          flush=True)
    cfg = blip2_config()
    m32 = blip2.build_model(cfg, device, lora=True, classifier=True)
    blip2.init_(m32, SEED + 240)
    blip2.init_lora_(m32.lora, SEED + 241, b_std=0.01)
    blip2.init_classifier_(m32.classifier, SEED + 242)
    m16 = copy.deepcopy(m32).cast_(torch.bfloat16)
    n_params = sum(t.numel() for t in m32.parameters())
    tok = get_tokenizer("opt")
    aft = _vlm_answer_tokens(tok)
    data = SyntheticVLMBatcher(VLM_BATCHES * VLM_BATCH, tok, SEED + 243)
    first = data.batch(0, VLM_BATCH)
    print(f"  BLIP-2 (blip2-opt-2.7b) {n_params / 1e9:.3f} B parameters "
          f"with the adapters and the classifier, fp32 and bf16 copies, "
          f"and {len(data.m)} samples in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # OPT's mask on the path: the full model's 32 query tokens, then the
    # left-padded prompt
    n_query = blip2.Blip2Config().qformer.n_query
    path_mask = torch.cat([torch.ones((VLM_BATCH, n_query),
                                      dtype=torch.int32),
                           torch.from_numpy(first["attention_mask"])], 1)
    ok = check_vlm_kernels(device, path_mask.to(device), results)

    out, total = {"parameters": n_params, "k2": results["vlm_k2"]}, {}
    for what in ("blip2", "qformer"):
        _zero_counters()
        lk = _vlm_logits(what, m32, first, aft, torch.float32, device)
        ran = _read_counters() == _want_launches(mha=VLM_K2[what])
        with plain_versions():
            truth = _vlm_logits(what, m32, first, aft, torch.float32, device)
        d32 = float((lk - truth).abs().max())
        rel = d32 / float(truth.abs().max())
        good = (ran and rel <= 1e-4 and bool(torch.isfinite(lk).all())
                and tuple(lk.shape) == (VLM_BATCH, 4))
        _zero_counters()
        lk16 = _vlm_logits(what, m16, first, aft, torch.bfloat16, device)
        ran16 = _read_counters() == _want_launches(mha_tc=VLM_K2[what])
        with plain_versions():
            lp16 = _vlm_logits(what, m16, first, aft, torch.bfloat16,
                               device)
        agree_ok, agr = fusion_agreement(lk16, lp16, truth)
        good &= ran16 and agree_ok and bool(torch.isfinite(lk16).all())
        ok &= good
        out[f"{what}_checks"] = {"fp32_max_logit_diff": d32,
                                 "fp32_relative": rel,
                                 "fp32_max_abs_logit":
                                     float(truth.abs().max()),
                                 "bf16": agr}
        print(f"  {what}: fp32 kernel vs plain max|d|={d32:.3e} "
              f"({rel:.2e} of max|logit| {float(truth.abs().max()):.3e}), "
              f"K2 {VLM_K2[what]} launches a batch; bf16 kernel vs plain "
              f"max|d|={agr['max_logit_diff']:.3e}, agreement "
              f"{agr['agreement']} above the floor {agr['noise_floor']:.3e} "
              f"({agr['samples'] - agr['excluded']} of {agr['samples']}; "
              f"all {agr['agreement_all']:.4f}), bf16 vs fp32 max|d|="
              f"{agr['bf16_vs_fp32']:.3e} {'ok' if good else 'FAIL'}",
              flush=True)

    del m32                        # the throughput runs hold bf16 alone
    gc.collect()
    torch.cuda.empty_cache()
    for what, bs in (("blip2", VLM_BATCH), ("blip2", VLM_BENCH_BATCH),
                     ("qformer", VLM_BATCH)):
        step = _vlm_step(what, m16, aft, torch.bfloat16)
        n_batches = len(data.m) // bs
        vlm_eval(step, data, bs, device)                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        _zero_counters()
        _, _, preds, stats = vlm_eval(step, data, bs, device)
        torch.cuda.synchronize()
        launches = _read_counters()
        peak = torch.cuda.max_memory_allocated(device)
        want = _want_launches(mha_tc=VLM_K2[what] * n_batches)
        good = launches == want and len(preds) == len(data.m)
        prof = profile_step(step, data.batch(0, bs), device, reps=2)
        k2_ms = prof["by_kind_ms"].get("mha kernel", 0.0)
        split = vlm_split(m16, data.batch(0, bs), device) \
            if what == "blip2" else None
        ok &= good
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        out[f"{what}_{bs}"] = {
            "batch": bs, "batches": n_batches,
            "samples_per_s": stats["samples_per_s"],
            "p50_batch_ms": stats["p50_step_s"] * 1e3,
            "peak_mem_gib": peak / 2**30,
            "device_ms_per_batch": prof["device_ms_per_batch"],
            "idle_share": prof["idle_share"], "k2_ms_per_batch": k2_ms,
            "k2_share": k2_ms / prof["device_ms_per_batch"],
            "by_kind_ms": prof["by_kind_ms"], "split": split,
            "launches": {k: v for k, v in launches.items() if v}}
        split_s = (f"; split of one batch: EVA {split['eva_ms']:.2f} ms, "
                   f"Q-Former {split['qformer_ms']:.2f} ms, OPT "
                   f"{split['opt_ms']:.2f} ms" if split else "")
        print(f"  {what} eval {n_batches} x {bs}: {stats['samples_per_s']:.1f}"
              f" samples/s, p50 {stats['p50_step_s'] * 1e3:.2f} ms, peak "
              f"{peak / 2**30:.2f} GiB, device "
              f"{prof['device_ms_per_batch']:.2f} ms a batch (idle "
              f"{prof['idle_share']:.3f}), K2 {k2_ms:.2f} ms "
              f"({k2_ms / prof['device_ms_per_batch']:.1%}); launches "
              f"{out[f'{what}_{bs}']['launches']} (want "
              f"{ {k: v for k, v in want.items() if v} }){split_s} "
              f"{'ok' if good else 'FAIL'}", flush=True)
    results["vlm_eval"] = out
    results["vlm_eval_launches"] = total
    results["vlm_model"] = m16
    results["vlm_seconds"] = time.perf_counter() - t0
    print(f"  vlm_eval launches over the three runs: "
          f"{ {k: v for k, v in total.items() if v} }; in "
          f"{results['vlm_seconds']:.1f} s", flush=True)
    return ok


def blip2_hf_state_dict(model):
    """The port model's weights as a peft-wrapped HF
    ``Blip2ForConditionalGeneration`` state dict on the host, in bf16: the
    layout ``models.vlm.blip2.convert_torch`` reads (``base_model.model.``
    prefixes, ``.base_layer`` names, ``lora_A`` [r, in] / ``lora_B``
    [out, r]), the tied lm head included."""
    import torch

    sd = {}

    def put(key, t):
        sd["base_model.model." + key] = t.detach().to(
            "cpu", torch.bfloat16).contiguous()

    def lin(key, m):
        put(key + ".weight", m.w)
        put(key + ".bias", m.b)

    def ln(key, m):
        put(key + ".weight", m.scale)
        put(key + ".bias", m.bias)

    def attn(pre, a):
        for leaf, m in (("attention.query", a.q), ("attention.key", a.k),
                        ("attention.value", a.v), ("output.dense", a.out)):
            lin(pre + leaf, m)
        ln(pre + "output.LayerNorm", a.ln)

    v = model.vision
    put("vision_model.embeddings.class_embedding", v.class_emb[None, None])
    put("vision_model.embeddings.position_embedding", v.pos_emb[None])
    put("vision_model.embeddings.patch_embedding.weight", v.patch_emb.w)
    put("vision_model.embeddings.patch_embedding.bias", v.patch_emb.b)
    for i, lay in enumerate(v.layers):
        pre = f"vision_model.encoder.layers.{i}."
        ln(pre + "layer_norm1", lay.ln1)
        lin(pre + "self_attn.qkv", lay.qkv)
        lin(pre + "self_attn.projection", lay.proj)
        ln(pre + "layer_norm2", lay.ln2)
        lin(pre + "mlp.fc1", lay.fc1)
        lin(pre + "mlp.fc2", lay.fc2)
    ln("vision_model.post_layernorm", v.post_ln)
    qf = model.qformer
    put("query_tokens", qf.query_tokens[None])
    ln("qformer.layernorm", qf.ln_emb)
    for i, lay in enumerate(qf.layers):
        pre = f"qformer.encoder.layer.{i}."
        attn(pre + "attention.", lay.att)
        if lay.cross is not None:
            attn(pre + "crossattention.", lay.cross)
        lin(pre + "intermediate_query.dense", lay.fc1_q)
        lin(pre + "output_query.dense", lay.fc2_q)
        ln(pre + "output_query.LayerNorm", lay.ln_ffn_q)
    lin("language_projection", model.projection)
    o, dec = model.opt, "language_model.model.decoder."
    put(dec + "embed_tokens.weight", o.embed_tokens.w)
    put(dec + "embed_positions.weight", o.embed_positions.w)
    ln(dec + "final_layer_norm", o.final_ln)
    for i, lay in enumerate(o.layers):
        pre = f"{dec}layers.{i}."
        ln(pre + "self_attn_layer_norm", lay.ln1)
        for name in ("q", "k"):
            proj = f"{pre}self_attn.{name}_proj."
            lin(proj + "base_layer", getattr(lay, name))
            pair = getattr(model.lora[str(i)], name)
            put(proj + "lora_A.default.weight", pair.a.t())
            put(proj + "lora_B.default.weight", pair.b.t())
        lin(pre + "self_attn.v_proj", lay.v)
        lin(pre + "self_attn.out_proj", lay.out)
        ln(pre + "final_layer_norm", lay.ln2)
        lin(pre + "fc1", lay.fc1)
        lin(pre + "fc2", lay.fc2)
    sd["base_model.model.language_model.lm_head.weight"] = \
        sd["base_model.model." + dec + "embed_tokens.weight"]
    return sd


def check_vlm_clis(device, results):
    """``cli.blip2_test`` and ``cli.qformer_test`` ``main()`` at full width
    on a generated 4 x 4 JPEG tree, from the phase's bf16 weights written
    as a peft-wrapped HF ``.pth`` (``blip2_hf_state_dict``) and, for the
    Q-Former, its classifier as a MultimodalClassifier ``.pth``: K2 71 /
    39 launches (one batch of 16), the report CSV (``drive_eval_main``)."""
    import gc
    import os
    import shutil

    import torch

    from garbage_classification_rca_tpu_torch.cli import (blip2_test,
                                                          qformer_test)

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_vlm_clis")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    model = results.pop("vlm_model")
    cwd = os.getcwd()
    ok, out, t1 = False, {}, time.perf_counter()
    try:
        ok = True
        t0 = time.perf_counter()
        _write_jpeg_tree(os.path.join(work, "garbage"), 0, 16, SEED + 260,
                         size=320)
        blip = os.path.join(work, "BLIP2_epoch_1_acc_0.5.pth")
        torch.save(blip2_hf_state_dict(model), blip)
        clf = os.path.join(work, "Classifier_epoch_1_acc_0.5.pth")
        torch.save({"classifier.weight": model.classifier.w.detach().cpu(),
                    "classifier.bias": model.classifier.b.detach().cpu()},
                   clf)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        save_s = time.perf_counter() - t0
        print(f"  the JPEG tree and the .pth files "
              f"({os.path.getsize(blip) / 2**30:.2f} GiB) in {save_s:.1f} s",
              flush=True)
        os.chdir(work)
        for cli, extra in ((blip2_test, []),
                           (qformer_test, [f"--classifier_weights={clf}"])):
            name = cli.__name__.rsplit(".", 1)[-1]
            argv = [f"--model_path={blip}", "--dataset_folder_name="
                    "garbage_Val"] + extra
            _zero_counters()
            t0 = time.perf_counter()
            main_ok, report = drive_eval_main(cli, argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = _read_counters()
            what = "blip2" if cli is blip2_test else "qformer"
            good = main_ok and launches == _want_launches(
                mha_tc=VLM_K2[what])
            print(f"  cli.{name} on 16 JPEGs in {secs:.1f} s (the .pth "
                  f"read included): launches "
                  f"{ {k: v for k, v in launches.items() if v} } "
                  f"{'ok' if good else 'FAIL'}", flush=True)
            out[name] = {"seconds": secs, "report": report, "ok": good}
            ok &= good
        out["save_s"] = save_s
        # phase 13's train CLIs start from the same .pth; it removes `work`
        results["vlm_work"], results["vlm_pth"] = work, blip
    finally:
        os.chdir(cwd)
        if not ok or "vlm_pth" not in results:
            shutil.rmtree(work, ignore_errors=True)
    out["phase_seconds"] = results["vlm_seconds"] + time.perf_counter() - t1
    print(f"  phase 12 in {out['phase_seconds']:.1f} s", flush=True)
    results["vlm_clis"] = out
    return ok


# ---------------------------------------------------------------------------
# phase 13: the VLM train path (BLIP-2 LoRA fine-tuning, the Q-Former
# classifier; K4a / K4b at head dim 80, K2 at head dim 88)
# ---------------------------------------------------------------------------

VLM_TRAIN_BATCH, VLM_ACC = 16, 8     # --batch_size and the recipes' acc 8
VLM_TRAIN_FP32_BATCH = 4             # the fp32 check beside the bf16 model
# per microbatch: K2 39 (EVA), K4a 32 and K4b 32 (OPT), all three on the
# tensor cores; the Q-Former K2 39
VLM_TRAIN_LAUNCHES = {"blip2": {"mha_tc": 39, "mha_fwd_lse_tc": 32,
                                "mha_flash_bwd_tc": 32},
                      "qformer": {"mha_tc": 39}}
VLM_LABEL_TOKENS = 4


def _vlm_train_kind(name: str) -> str:
    """Phase 13's kinds: K2 / K4a on the tensor cores (one kernel template,
    ``ftc::wide_kernel<DH, MASKED, CAUSAL, LSE>``) or the CUDA cores
    (``mha_kernel<T, DH, LSE, DROP>``; K4a writes the lse), K4b's two
    kernels on the tensor cores (``ftc::dq_wide_kernel`` /
    ``dkdv_wide_kernel``) or the CUDA cores (``mha_bwd_*``), and
    ``_kind``'s for the rest."""
    n = name.lower()
    if _wide_bwd(n) or "mha_bwd" in n:
        return "K4b mha_flash_bwd (head dim 80)"
    if "wide_kernel" in n:
        return ("K4a mha_fwd_lse (head dim 80)" if _wide_lse(n)
                else "K2 mha (head dim 88)")
    if "mha_kernel" in n:
        return ("K4a mha_fwd_lse (head dim 80)" if ", true, false>" in n
                else "K2 mha (head dim 88)")
    return _kind(name)


def _vlm_train_window(n_micro, batch, tok, seed, device, label_tokens=True):
    """[n_micro, batch, ...] device window of SyntheticVLMBatcher samples
    with the answer word's label tokens of each label (pad id 1 after
    them), as ``cli.blip2_common.Blip2Batcher`` makes them."""
    import numpy as np
    import torch

    from garbage_classification_rca_tpu_torch.models.vlm.prompts import (
        FOLDER_TO_ANSWER)

    data = SyntheticVLMBatcher(n_micro * batch, tok, seed)
    if label_tokens:
        rows = []
        for c in VLM_CLASSES:
            ids = tok.encode_one(FOLDER_TO_ANSWER[c], VLM_LABEL_TOKENS)[0]
            rows.append(ids + [tok.pad_id] * (VLM_LABEL_TOKENS - len(ids)))
        data.samples["label_tokens"] = np.asarray(rows, np.int32)[
            data.samples["label"]]
    return {k: torch.from_numpy(v.reshape((n_micro, batch) + v.shape[1:]))
            .to(device) for k, v in data.samples.items()}


def _vlm_train_bound(q, mask, causal=True):
    """(flops_fwd, bytes_fwd, flops_bwd, bytes_bwd) of the flash pair on
    q [B, N, D] with this run's mask: the products over the (query, key)
    pairs the causal mask and the key mask allow (QK^T and PV forward; S,
    dP, dV, dQ, dK backward), each input read once and each output
    written once (q, k, v, out, lse, mask; + dO, dQ, dK, dV backward)."""
    b, n, d = q.shape
    h = d // 80
    pairs_flops = _k2_flops(b, n, d, mask, causal)        # 4 * pairs * d
    item = q.element_size()
    lse = b * h * n * 4
    m = mask.numel() * 4
    return (pairs_flops, 4 * q.numel() * item + lse + m,
            pairs_flops // 4 * 10, 8 * q.numel() * item + lse + m)


def check_vlm_train_kernels(device, path_mask, results):
    """K4a / K4b at OPT-2.7B's LoRA shape, 16 x 136 x 2560 (32 heads of 80,
    causal, the path's left-pad key mask), fp32 and bf16, against the
    plain pair (``_held_to_plain``: fp32 1e-5 + 1e-5|x| / 5e-5 (1 + |x|);
    bf16 one ulp + 1e-3 / one ulp + 2e-3 max), with a fully masked and a
    single-key sample, and at N = 1. fp32 runs the CUDA cores on both
    sides; bf16 runs the pair on both of its plans on the same inputs: the
    CUDA cores (``route="cuda_core"``) as in fp32, and the default, both
    sides on the tensor cores (K4a at the one-flip bar on the output, lse
    1e-5 + 1e-5|x|; K4b from that forward's out and lse at the bf16
    backward bar, dQ / dK at N = 1 at ``_single_key``'s); each launch on
    its route's counter; the default also with a sample whose first 100
    keys are pads (``_late_mask``). Then the path's bf16 call timed (CUDA
    graphs of 20 launches, median of 5): K4a and K4b each on both routes
    new-old-old-new, beside the plain pair, the library's efficient
    attention with the equivalent additive bias (forward + lse, and its
    backward) and the bound; two runs of the tensor-core K4b give the
    same bits."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

    gen = torch.Generator().manual_seed(SEED + 280)
    b, n, d, h = path_mask.shape[0], path_mask.shape[1], 2560, 32
    edge = path_mask.clone()
    edge[0] = 0                                       # every key a pad
    edge[1] = 0
    edge[1, -1] = 1                                   # one valid key
    ok_all, errs = True, {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for label, nn_, m in (("path", n, path_mask), ("edge", n, edge),
                              ("N=1", 1, torch.ones((b, 1), dtype=torch.int32,
                                                    device=device))):
            q, k, v, do = (torch.randn((b, nn_, d), generator=gen).to(
                device, dtype) for _ in range(4))
            routes = [("cuda_core", ("cuda_core", "cuda_core"))]
            if bf16:
                routes.append((None, ("tc", "tc")))
            for route, want_plan in routes:
                ok_all &= _vlm_pair_case(K, q, k, v, do, h, m, route,
                                         want_plan, label, errs)
        if bf16:
            q, k, v, do = (torch.randn((b, n, d), generator=gen).to(
                device, dtype) for _ in range(4))
            ok_all &= _vlm_pair_case(K, q, k, v, do, h,
                                     _late_mask(path_mask, n, 100), None,
                                     ("tc", "tc"), "late", errs)
    # the path's call in bf16, timed
    q, k, v, do = (torch.randn((b, n, d), generator=gen).to(
        device, torch.bfloat16) for _ in range(4))
    o, lse = K.mha_fwd_lse(q, k, v, heads=h, mask=path_mask, causal=True)
    tc = K.flash_plan(q.shape, h, q.dtype)
    old = K.flash_plan(q.shape, h, q.dtype, route="cuda_core")
    fwd = {r: functools.partial(K.launch_fwd_lse, p, q, k, v, heads=h,
                                mask=path_mask, causal=True)
           for r, p in (("tc", tc), ("cuda_core", old))}
    ab = {"tc": [], "cuda_core": []}
    for route in ("tc", "cuda_core", "cuda_core", "tc"):
        ab[route].append(time_ms(fwd[route])[0])
    ms_f = sum(ab["tc"]) / 2
    bwd = {r: functools.partial(K.launch_flash_bwd, p, q, k, v, o, do, lse,
                                heads=h, mask=path_mask, causal=True)
           for r, p in (("tc", tc), ("cuda_core", old))}
    ab_b = {"tc": [], "cuda_core": []}
    for route in ("tc", "cuda_core", "cuda_core", "tc"):
        ab_b[route].append(time_ms(bwd[route])[0])
    ms_b = sum(ab_b["tc"]) / 2
    same = all(torch.equal(x, y) for x, y in zip(bwd["tc"](), bwd["tc"]()))
    ok_all &= same
    print(f"  K4b tensor cores, two runs on the path's inputs: "
          f"{'the same bits' if same else 'DIFFER'}", flush=True)
    plain_f = time_ms(lambda: K.mha_fwd_lse_reference(
        q, k, v, heads=h, mask=path_mask, causal=True))[0]
    plain_b = time_ms(lambda: K.mha_flash_bwd_reference(
        q, k, v, o, do, lse, heads=h, mask=path_mask, causal=True))[0]
    allowed = path_mask.bool()[:, None, :] & torch.ones(
        (n, n), dtype=torch.bool, device=device).tril()[None]
    bias = torch.where(allowed, 0.0, K.NEG).to(torch.bfloat16)[:, None]
    bias = bias.expand(b, h, n, n).contiguous()
    lib = _efficient_attention(q, k, v, bias, h)
    lib_f = time_ms(lambda: _efficient_attention(q, k, v, bias, h))[0]
    rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)
    lib_b = time_ms(lambda: torch.ops.aten.
                    _scaled_dot_product_efficient_attention_backward(
                        rs(do), rs(q), rs(k), rs(v), bias, lib[0], lib[1],
                        lib[2], lib[3], 0.0, [True, True, True, False]))[0]
    del lib, bias
    fl_f, by_f, fl_b, by_b = _vlm_train_bound(q, path_mask)
    rows = {}
    for name, line, ms, plain, lib_ms, flops, nbytes, side, extra in (
            ("mha_fwd_lse_hd80", 274, (ms_f, min(ab["tc"]), max(ab["tc"])),
             plain_f, lib_f, fl_f, by_f, "fwd",
             {"kernel_route": "tc", "ms_runs": ab["tc"],
              "cuda_core_ms": sum(ab["cuda_core"]) / 2,
              "cuda_core_ms_runs": ab["cuda_core"]}),
            ("mha_flash_bwd_hd80", 317, (ms_b, min(ab_b["tc"]),
                                         max(ab_b["tc"])),
             plain_b, lib_b, fl_b, by_b, "bwd",
             {"kernel_route": "tc", "ms_runs": ab_b["tc"],
              "cuda_core_ms": sum(ab_b["cuda_core"]) / 2,
              "cuda_core_ms_runs": ab_b["cuda_core"],
              "bit_identical_runs": same})):
        row = _fwd_row(name, ms[0], plain, lib_ms, flops, nbytes,
                       max(e[side] for e in errs.values()), line,
                       "bfloat16", max_abs_err_by_case={
                           k_: e[side] for k_, e in errs.items()},
                       ms_min_max=ms[1:], shape=[b, n, d],
                       heads=h, head_dim=80, causal=True, dtype="bfloat16",
                       operations=flops, bytes_moved=nbytes, **extra)
        row["cuda_core_share_of_bound"] = (row["bound_ms"]
                                           / extra["cuda_core_ms"])
        rows[name] = row
        runs = ab if side == "fwd" else ab_b
        old_s = (f", CUDA cores {runs['cuda_core'][0]:.4f} / "
                 f"{runs['cuda_core'][1]:.4f} ms (new-old-old-new: tc "
                 f"{runs['tc'][0]:.4f} / {runs['tc'][1]:.4f})")
        print(f"  {name} bf16 {b}x{n}x{d}, 32 heads of 80, causal + mask, "
              f"{extra['kernel_route']}: {ms[0]:.4f} ms ({ms[1]:.4f}-"
              f"{ms[2]:.4f}){old_s}; plain {plain:.4f} ms, efficient "
              f"attention (additive bias) {lib_ms:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); share of the "
              f"bound {row['share_of_bound']:.3f}; / library "
              f"{ms[0] / lib_ms:.2f}", flush=True)
    results["vlm_train_kernels"] = rows
    return ok_all


def _vlm_pair_case(K, q, k, v, do, h, m, route, want_plan, label, errs):
    """The flash pair at head dim 80, causal, on one case under `route`
    (None: the default plan), against the plain pair: `want_plan` its
    (forward, backward) routes, one launch on each route's counter; the
    tensor-core forward at the one-flip bar (``_held_to_plain``'s
    `edge`), the tensor-core backward and the CUDA-core pair at the plain
    bars (``_single_key`` at N = 1 in bf16). Records the errors under
    "<dtype>_<label>" (with "_tc" for the default route in bf16)."""
    import torch

    plan = K.flash_plan(q.shape, h, q.dtype, route=route)
    f0 = dict(K.mha_fwd_lse.route_launches)
    b0 = dict(K.mha_flash_bwd.route_launches)
    o, lse = K.mha_fwd_lse(q, k, v, heads=h, mask=m, causal=True) \
        if route is None else K.launch_fwd_lse(plan, q, k, v, heads=h,
                                               mask=m, causal=True)
    grads = K.mha_flash_bwd(q, k, v, o, do, lse, heads=h, mask=m,
                            causal=True) if route is None else \
        K.launch_flash_bwd(plan, q, k, v, o, do, lse, heads=h, mask=m,
                           causal=True)
    torch.cuda.synchronize()
    bf16 = q.dtype == torch.bfloat16
    nn_ = q.shape[1]
    e_f, e_b, ok = _held_to_plain(
        q, k, v, do, h, m, True, o, lse, grads,
        edge=bf16 and (plan.route == "tc" or nn_ == 1))
    ok &= (plan.route, plan.bwd_route) == want_plan
    ok &= K.mha_fwd_lse.route_launches == {
        **f0, want_plan[0]: f0[want_plan[0]] + 1}
    ok &= K.mha_flash_bwd.route_launches == {
        **b0, want_plan[1]: b0[want_plan[1]] + 1}
    tag = f"{str(q.dtype)[6:]}_{label}" + ("_tc" if route is None and bf16
                                           else "")
    errs[tag] = {"fwd": e_f, "bwd": e_b}
    print(f"  flash pair {plan.route}/{plan.bwd_route} {str(q.dtype)[6:]:8s} "
          f"B={q.shape[0]} N={nn_:3d} D={q.shape[2]} H={h} (head dim 80) "
          f"causal mask={label}: fwd max|d|={e_f:.3e} bwd {e_b:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def _adapter_grads(model, mb, dtype):
    """(loss, {adapter: grad}) of ``blip2.lm_loss`` on one microbatch."""
    import torch

    from garbage_classification_rca_tpu_torch.cli.blip2_train import (
        _assemble_lm_batch)
    from garbage_classification_rca_tpu_torch.models.vlm import blip2

    model.lora.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss = blip2.lm_loss(model, *_assemble_lm_batch(mb, dtype))
        loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                         for n, p in model.lora.named_parameters()}


VLM_CONTROL_DRAWS = 3    # draws of the one-ulp control


@functools.cache
def flash_pair_plain():
    """OPT's flash pair on its plain versions under one autograd function:
    ``mha_fwd_lse_reference`` forward, ``mha_flash_bwd_reference``
    backward (the kernels' own rounding points), with ``mha_flash_train``'s
    signature."""
    import torch

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

    class FlashPairPlain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask, heads, scale, causal):
            o, lse = K.mha_fwd_lse_reference(q, k, v, heads=heads,
                                             scale=scale, mask=mask,
                                             causal=causal)
            ctx.save_for_backward(q, k, v, o, lse, mask)
            ctx.args = (heads, scale, causal)
            return o

        @staticmethod
        def backward(ctx, g):
            q, k, v, o, lse, mask = ctx.saved_tensors
            heads, scale, causal = ctx.args
            grads = K.mha_flash_bwd_reference(
                q, k, v, o, g.to(q.dtype), lse, heads=heads, scale=scale,
                mask=mask, causal=causal)
            return (*grads, None, None, None, None)

    def call(q, k, v, *, heads, scale=0.0, mask=None, causal=False):
        return FlashPairPlain.apply(q, k, v, mask, heads, scale, causal)

    return call


@contextlib.contextmanager
def opt_attention(model, fn=None, ulp=0.0, seed=5):
    """OPT's training attention on `fn` where given (else the flash pair);
    with `ulp`, the projection's output (OPT's query embeddings) moved by
    N(0, 1) ulps of that size, drawn from `seed`."""
    import torch

    from garbage_classification_rca_tpu_torch.models.vlm import opt

    saved = opt.mha_flash_train
    opt.mha_flash_train = fn or saved
    hook = None
    if ulp:
        g = torch.Generator(device=model.projection.w.device).manual_seed(
            seed)
        hook = model.projection.register_forward_hook(
            lambda mod, i, o: o * (1.0 + ulp * torch.randn(
                o.shape, generator=g, device=o.device)).to(o.dtype))
    try:
        yield
    finally:
        opt.mha_flash_train = saved
        if hook is not None:
            hook.remove()


def grad_score(got, want, dtype):
    """fp32: max |got - want| over the tensor's largest |want|; bf16: the
    cosine of the two."""
    import torch

    if dtype == torch.float32:
        return float((got - want).abs().max() / want.abs().max())
    return float(torch.nn.functional.cosine_similarity(
        got.flatten().double(), want.flatten().double(), dim=0))


def compare_vlm_train_paths(model, mb, dtype):
    """The LoRA loss and every adapter gradient of one microbatch on the
    kernel path against the same path with OPT's flash pair on its plain
    versions (``flash_pair_plain``); EVA runs K2 on both sides (held to its
    plain version at this head dim in phase 12), so the two differ only in
    K4a / K4b. PERF.md §2's train bars: fp32 loss within 1e-5 relative
    and each gradient within 1e-4 of its tensor's largest |g|; bf16 loss
    within 1e-3 relative and each gradient's cosine >= 0.999.

    The random 3.74 B model's adapter gradients are ill-conditioned there:
    the plain path with OPT's query embeddings moved by one ulp of the
    compute dtype (the control, in the same run, drawn VLM_CONTROL_DRAWS
    times) moves those of the first 20 OPT layers by about 3e-3 of their
    largest |g| (fp32) and to a cosine of about 0.998 (bf16), past either
    bar (PERF.md §6). So a gradient that misses its bar passes if the
    kernel path moves it no further than the furthest any control draw
    moves any gradient (factor 1). The count within the bar itself, the
    control's worst and the kernel path's worst are reported.
    Returns (ok, summary)."""
    import torch

    plain = flash_pair_plain()
    lk, gk = _adapter_grads(model, mb, dtype)
    with opt_attention(model, plain):
        lp, gp = _adapter_grads(model, mb, dtype)
    fp32 = dtype == torch.float32
    pick = max if fp32 else min
    worse = (lambda a, b: a > b) if fp32 else (lambda a, b: a < b)
    control, loss_control = {}, 0.0
    for seed in range(5, 5 + VLM_CONTROL_DRAWS):
        with opt_attention(model, plain, ulp=2.0 ** -23 if fp32
                           else 2.0 ** -8, seed=seed):
            lc, gc_ = _adapter_grads(model, mb, dtype)
        loss_control = max(loss_control, abs(lc - lp) / abs(lp))
        for n, g in gc_.items():
            s_ = grad_score(g, gp[n], dtype)
            control[n] = pick(control.get(n, s_), s_)
        del gc_
    rel = abs(lk - lp) / abs(lp)
    ok = rel <= (1e-5 if fp32 else 1e-3)
    score = {n: grad_score(g, gp[n], dtype) for n, g in gk.items()}
    bar = 1e-4 if fp32 else 0.999
    limit = pick(control.values())
    met = [n for n, s_ in score.items() if not worse(s_, bar)]
    for n, g in gk.items():
        ok &= not worse(score[n], bar) or not worse(score[n], limit)
        ok &= bool(torch.isfinite(g).all())
    worst = pick(score, key=score.get)
    model.lora.zero_grad(set_to_none=True)
    return ok, {"loss_kernel": lk, "loss_plain": lp, "loss_relative": rel,
                "loss_control_relative": loss_control,
                "gradients": len(gk), "met_the_bar": len(met), "bar": bar,
                "worst_gradient": (worst, score[worst], control[worst]),
                "control_worst": limit,
                "control_draws": VLM_CONTROL_DRAWS,
                "missed_the_bar": {n: (s_, control[n]) for n, s_ in
                                   score.items() if n not in met}}


def _vlm_check_line(c):
    name, score, ctl = c["worst_gradient"]
    return (f"loss {c['loss_kernel']:.6f} / {c['loss_plain']:.6f} (relative "
            f"{c['loss_relative']:.2e}; control "
            f"{c['loss_control_relative']:.2e}); {c['met_the_bar']} of "
            f"{c['gradients']} gradients within the bar {c['bar']}; worst "
            f"{name} {score:.6g} (the control there {ctl:.6g}); the "
            f"control's worst over {c['control_draws']} draws "
            f"{c['control_worst']:.6g}")


def check_vlm_train(device, results):
    """BLIP-2 LoRA training at full width and depth (blip2-opt-2.7b, bf16
    towers, fp32 adapters with B != 0), microbatch 16 x acc 8: K4a / K4b at
    16 x 136 x 2560 (``check_vlm_train_kernels``); one warm-up optimizer
    step and two timed, the counters zeroed before and read after (per
    microbatch K2 39, K4a 32, K4b 32, the rest 0): train samples/s, steps/s,
    peak memory, a profile (device ms a step, idle share, by kind); one
    step with ``hf_internal_dropout`` (the same launches, K7 0); the loss
    and adapter gradients of a microbatch on the kernel path against OPT's
    flash pair on its plain versions in bf16 (batch 16) and fp32 (batch
    4, TF32 off in matmuls and convolutions); then the
    Q-Former classifier's step at 16 x 8 (K2 39 a microbatch)."""
    import gc

    import torch

    from garbage_classification_rca_tpu_torch.cli import blip2_train
    from garbage_classification_rca_tpu_torch.cli import qformer_train
    from garbage_classification_rca_tpu_torch.cli.blip2_common import (
        blip2_config)
    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        get_tokenizer)
    from garbage_classification_rca_tpu_torch.models.vlm import blip2
    from garbage_classification_rca_tpu_torch.nn.core import Key

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = blip2_config()
    tok = get_tokenizer("opt")
    window = _vlm_train_window(VLM_ACC, VLM_TRAIN_BATCH, tok, SEED + 271,
                               device)
    n_query = cfg.qformer.n_query
    path_mask = torch.cat(
        [torch.ones((VLM_TRAIN_BATCH, n_query), dtype=torch.int32,
                    device=device), window["attention_mask"][0],
         (window["label_tokens"][0] != tok.pad_id).to(torch.int32)], 1)
    ok = check_vlm_train_kernels(device, path_mask, results)

    model = blip2.build_model(cfg, device, lora=True, classifier=True)
    blip2.init_(model, SEED + 240)
    blip2.init_lora_(model.lora, SEED + 241, b_std=0.01)
    blip2.init_classifier_(model.classifier, SEED + 242)
    model.cast_(torch.bfloat16, keep_fp32=("lora",))
    print(f"  BLIP-2 bf16 with fp32 adapters (B != 0) and {VLM_ACC} x "
          f"{VLM_TRAIN_BATCH} samples in {time.perf_counter() - t0:.1f} s",
          flush=True)
    out, total = {}, {}
    samples = VLM_ACC * VLM_TRAIN_BATCH
    key = Key(SEED + 272)
    for what, flag in (("blip2", False), ("blip2", True), ("qformer", False)):
        if what == "blip2":
            _, step = blip2_train.make_lora_train_step(
                model, compute_dtype=torch.bfloat16, hf_internal_dropout=flag)
        else:
            _, step, _ = qformer_train.make_steps(
                model, compute_dtype=torch.bfloat16)
        tag = f"{what}{'_hf_dropout' if flag else ''}"
        n_steps = 1 if flag else 2
        float(step(window, key.fold_in(99)))                    # warm-up
        wall, losses, launches, peak = _timed_steps(
            [lambda s_, k_: (step(s_, k_),)] * n_steps, window, key, device)
        want = _want_launches(**{k: v * VLM_ACC * n_steps for k, v in
                                 VLM_TRAIN_LAUNCHES[what].items()})
        good = launches == want and all(
            torch.isfinite(torch.tensor(losses)).tolist())
        # the hf_internal_dropout step runs the same kernels: not profiled
        prof = {k: None for k in ("device_ms_per_step", "wall_ms_per_step",
                                  "idle_share", "by_kind_ms")} if flag \
            else profile_train_step(lambda s, k_: (step(s, k_),), window,
                                    key, acc_steps=VLM_ACC,
                                    kind=_vlm_train_kind)
        ok &= good
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        out[tag] = {
            "microbatch": VLM_TRAIN_BATCH, "acc_steps": VLM_ACC,
            "steps": n_steps, "losses": losses,
            "train_samples_per_s": samples * n_steps / wall,
            "steps_per_s": n_steps / wall, "peak_mem_gib": peak / 2**30,
            "device_ms_per_step": prof["device_ms_per_step"],
            "wall_ms_per_step": prof["wall_ms_per_step"],
            "idle_share": prof["idle_share"],
            "by_kind_ms": prof["by_kind_ms"], "launches": _shown(launches)}
        print(f"  {tag} train, {n_steps} x ({VLM_ACC} x {VLM_TRAIN_BATCH}): "
              f"{samples * n_steps / wall:.1f} train samples/s, "
              f"{n_steps / wall:.3f} steps/s, peak {peak / 2**30:.2f} GiB, "
              f"losses {[round(x, 5) for x in losses]}; launches "
              f"{_shown(launches)} (want {_shown(want)}) "
              f"{'ok' if good else 'FAIL'}", flush=True)

    # the kernel path against the plain path on a microbatch
    checks = {}
    mb16 = {k: v[0] for k, v in window.items()}
    model.requires_grad_(False)
    model.lora.requires_grad_(True)
    good, checks["bf16"] = compare_vlm_train_paths(model, mb16,
                                                   torch.bfloat16)
    ok &= good
    print(f"  bf16 LoRA microbatch of {VLM_TRAIN_BATCH}, kernel vs the "
          f"pair's plain versions: "
          f"{_vlm_check_line(checks['bf16'])} {'ok' if good else 'FAIL'}",
          flush=True)
    m32 = blip2.build_model(cfg, device, lora=True)
    blip2.init_(m32, SEED + 240)
    blip2.init_lora_(m32.lora, SEED + 241, b_std=0.01)
    m32.lora.requires_grad_(True)
    mb4 = {k: v[:VLM_TRAIN_FP32_BATCH] for k, v in mb16.items()}
    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False        # EVA's patch conv too
    try:
        good, checks["fp32"] = compare_vlm_train_paths(m32, mb4,
                                                       torch.float32)
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
    ok &= good
    print(f"  fp32 LoRA microbatch of {VLM_TRAIN_FP32_BATCH} (TF32 off), "
          f"kernel vs the pair's plain versions: "
          f"{_vlm_check_line(checks['fp32'])} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    del m32, model
    gc.collect()
    torch.cuda.empty_cache()
    out["kernel_vs_plain"] = checks
    results["vlm_train"] = out
    results["vlm_train_launches"] = total
    results["vlm_train_seconds"] = time.perf_counter() - t0
    print(f"  vlm_train launches over the four runs: {_shown(total)}; in "
          f"{results['vlm_train_seconds']:.1f} s", flush=True)
    return ok


def check_vlm_train_clis(device, results):
    """``cli.blip2_train.main`` and ``cli.qformer_train.main`` for one
    epoch (``--batch_size=16``) from phase 12's ``.pth`` on a generated
    4-class ``_Train`` / ``_Val`` tree of 16 + 16 JPEGs, each run's
    launches counted (BLIP-2: a train microbatch K2 39 + K4a 32 + K4b 32
    and a val batch K2 71; the Q-Former: K2 39 + 39); then
    ``cli.blip2_test`` on the adapters' BEST file and ``cli.qformer_test``
    on the classifier's (``drive_eval_main``). Removes phase 12's work
    directory."""
    import glob
    import os
    import shutil

    import torch

    from garbage_classification_rca_tpu_torch.cli import (blip2_test,
                                                          blip2_train,
                                                          qformer_test,
                                                          qformer_train)

    work, blip = results["vlm_work"], results["vlm_pth"]
    cwd = os.getcwd()
    ok, out, t1 = True, {}, time.perf_counter()
    try:
        _write_jpeg_tree(os.path.join(work, "vlm"), 16, 16, SEED + 273,
                         size=320)
        os.chdir(work)
        base = ["--dataset_folder_name=vlm", "--batch_size=16",
                "--epochs=1"]
        want = {"blip2_train": {"mha_tc": 39 + 71, "mha_fwd_lse_tc": 32,
                                "mha_flash_bwd_tc": 32},
                "qformer_train": {"mha_tc": 39 + 39}}
        best = {}
        for cli in (blip2_train, qformer_train):
            name = cli.__name__.rsplit(".", 1)[-1]
            _zero_counters()
            t0 = time.perf_counter()
            result = cli.main(base + [f"--model_path={blip}"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = _read_counters()
            files = glob.glob(os.path.join("model_weights", "*",
                                           "BEST_*"))
            kind = "blip2_lora" if cli is blip2_train else \
                "qformer_classifier"
            best[name] = [f for f in files if f"/{kind}/" in f]
            good = (launches == _want_launches(**want[name])
                    and len(best[name]) == 1
                    and result.best_path == os.path.abspath(best[name][0]))
            print(f"  cli.{name} one epoch in {secs:.1f} s (the .pth read "
                  f"included): best val acc {result.best_val_acc:.2f}, "
                  f"launches {_shown(launches)} "
                  f"{'ok' if good else 'FAIL'}", flush=True)
            out[name] = {"seconds": secs, "val_acc": result.best_val_acc,
                         "launches": _shown(launches), "ok": good}
            ok &= good
        for cli, argv, k2 in (
                (blip2_test, [f"--model_path={best['blip2_train'][0]}"], 71),
                (qformer_test, [f"--model_path={blip}",
                                "--classifier_weights="
                                f"{best['qformer_train'][0]}"], 39)):
            name = cli.__name__.rsplit(".", 1)[-1]
            _zero_counters()
            t0 = time.perf_counter()
            main_ok, report = drive_eval_main(
                cli, argv + ["--dataset_folder_name=vlm_Val"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            good = main_ok and _read_counters() == _want_launches(
                mha_tc=k2)
            print(f"  cli.{name} on the BEST file in {secs:.1f} s "
                  f"{'ok' if good else 'FAIL'}", flush=True)
            out[name] = {"seconds": secs, "report": report, "ok": good}
            ok &= good
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    out["phase_seconds"] = (results["vlm_train_seconds"]
                            + time.perf_counter() - t1)
    print(f"  phase 13 in {out['phase_seconds']:.1f} s", flush=True)
    results["vlm_train_clis"] = out
    return ok


# the VLM RESUME cases: 20 train JPEGs at --batch_size=2 are 10
# microbatches, 2 windows of acc 8 an epoch; the 3rd step call is epoch
# 1's first window (RESUME holds epoch 0's end), the 4th its second
# (RESUME holds one window of epoch 1)
VLM_RESUME_KILLS = [("killed at the epoch boundary", 3),
                    ("killed mid-epoch", 4)]


def check_vlm_resume(device, results):
    """Phase 13's RESUME cases (``_resume_case``): ``cli.blip2_train``
    (blip2-opt-2.7b from ``--seed``, bf16 backbone, fp32 LoRA adapters)
    and ``cli.qformer_train`` at full width on 20 + 4 generated JPEGs,
    ``--batch_size=2 --epochs=2 --resume_every_steps=1``, each killed at
    ``VLM_RESUME_KILLS`` and resumed with ``--resume_from``, held to two
    uninterrupted runs; the resumed LoRA runs launch K2 (EVA's head dim 88
    and, in the val eval, OPT's 80), K4a and K4b (80), the Q-Former's K2.
    In a work directory of the checkout, deleted afterwards."""
    import os
    import shutil

    from garbage_classification_rca_tpu_torch.cli import (blip2_train,
                                                          qformer_train)

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_vlm_resume")
    shutil.rmtree(work, ignore_errors=True)
    cwd = os.getcwd()
    out, ok, t0 = {}, True, time.perf_counter()
    try:
        _write_jpeg_tree(os.path.join(work, "vlm"), 20, 4, SEED + 275,
                         size=224)
        argv = [f"--dataset_folder_name={work}/vlm", "--batch_size=2",
                "--epochs=2", "--resume_every_steps=1",
                f"--vocab_dir={here}/tests/fixtures/vocab/bpe"]
        for cli, name, factory, want_k in (
                (blip2_train, "blip2_lora", "make_lora_train_step",
                 ("K2", "K4a", "K4b")),
                (qformer_train, "qformer_classifier", "make_steps",
                 ("K2",))):
            short = cli.__name__.rsplit(".", 1)[-1]
            t1 = time.perf_counter()
            good, out[short] = _resume_case(
                f"cli.{short}", cli, argv, name, VLM_RESUME_KILLS,
                os.path.join(work, short), want_k=want_k, factory=factory,
                resume_flag="--resume_from")
            out[short]["seconds"] = time.perf_counter() - t1
            ok &= good
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 13's RESUME cases in {out['seconds']:.1f} s", flush=True)
    results["vlm_resume"] = out
    return ok


# ---------------------------------------------------------------------------
# phase 14: the late-fusion train path (every strategy and tower the JAX
# package trains, MM-RCA on DistilBERT aside: phase 5 trains it)
# ---------------------------------------------------------------------------

FUSION_TRAIN_ACC = 2        # microbatches a step: MM_RCA.sh's 10, cut
FUSION_TRAIN_PAIRS = (
    tuple((t, s) for t in ("distilbert", "bert")
          for s in ("gated", "classic", "normalized", "clip",
                    "hierarchical", "bimodal"))
    + (("bert", "MM_RCA"),)
    + tuple(("bart", s) for s in ("gated", "classic", "normalized", "clip")))
# the towers' depths: DistilBERT's 6; BERT-base's 12 cut to 4 (the
# hierarchical head taps hidden states 2 and 4) and BART-large's 12 + 12 to
# 1 + 1, at full width, to keep the script within its time
FUSION_TRAIN_DEPTH = {"distilbert": 6, "bert": 4, "bart": 1}
# K4a / K4b (K7a / K7b with hf_internal_dropout) a microbatch: one a text
# layer; BART runs no kernel
FUSION_TRAIN_LAYERS = {"distilbert": 6, "bert": 4, "bart": 0}
# one more step with hf_internal_dropout on a pair of each tower
FUSION_HF_PAIRS = (("distilbert", "gated"), ("bert", "hierarchical"),
                   ("bart", "classic"))


def fusion_train_launches(tower, strategy, n_micro, dropout=False):
    """Every counter's value after a fusion train step of `n_micro`
    microbatches: K4a (CUDA cores) and K4b (3xTF32) one a text layer and
    microbatch, K7a / K7b instead with ``hf_internal_dropout``, K1 / K3 one
    a microbatch on MM-RCA, the rest 0."""
    n = FUSION_TRAIN_LAYERS[tower] * n_micro
    pair = (("mha_fwd_lse_drop_tc32", "mha_flash_bwd_drop_tc32") if dropout
            else ("mha_fwd_lse", "mha_flash_bwd_tc32"))
    counts = {k: n for k in pair if n}
    if strategy == "MM_RCA":
        counts.update(rca_fused=n_micro, rca_fused_bwd=n_micro)
    return _want_launches(**counts)


def _fusion_train_towers(device):
    """The towers the pairs share, unfolded on the card in fp32, random
    weights from seeds: EfficientNetV2-M (random BN statistics),
    DistilBERT, BERT-base and BART-large at ``FUSION_TRAIN_DEPTH``."""
    import torch

    from garbage_classification_rca_tpu_torch.models.fusion import multimodal
    from garbage_classification_rca_tpu_torch.models.image import (
        efficientnet_common as eff, efficientnet_v2 as effv2)

    gen = lambda s: torch.Generator().manual_seed(s)
    towers = {"image": eff.EffNet(effv2.CONFIGS["eff_v2_medium"],
                                  generator=gen(SEED + 300)).to(device)}
    _randomize_bn(towers["image"], torch.Generator(
        device=device).manual_seed(SEED + 301))
    for i, name in enumerate(("distilbert", "bert", "bart")):
        towers[name] = multimodal.TEXT_TOWERS[name](
            FUSION_TRAIN_DEPTH[name], generator=gen(SEED + 302 + i)).to(device)
    return towers


def compare_fusion_train_paths(model, cfg, mb, class_weights, key):
    """One microbatch's loss and gradients, the kernel path against the
    plain path from the same weights and draws, with phase 5's bars
    (``compare_train_paths``): fp32 images, TF32 off, the loss within 1e-5
    relative and every gradient within 1e-4 of its tensor's largest |g|;
    bf16 images, the loss within 1e-3 relative and every gradient's cosine
    >= BF16_COS (>= BF16_COS_IMAGE in the image tower); the biases that may
    be rounding noise held to their sibling weights. -> (ok, numbers)."""
    import torch

    ok, out = True, {}
    exact_zero = exact_zero_grads(model)
    torch.backends.cudnn.deterministic = True
    for image_dtype in (torch.float32, torch.bfloat16):
        fp32 = image_dtype == torch.float32
        torch.backends.cudnn.allow_tf32 = not fp32
        lk, gk = _microbatch_grads(model, cfg, mb, image_dtype, key,
                                   class_weights)
        with plain_versions():
            lp, gp = _microbatch_grads(model, cfg, mb, image_dtype, key,
                                       class_weights)
        rel = abs(lk - lp) / max(abs(lp), 1e-30)
        scores, biases, zeros, finite = _grad_scores(gk, gp, fp32,
                                                     exact_zero)
        good = (finite and lk == lk and rel <= (1e-5 if fp32 else 1e-3)
                and all(z <= 0.1 for z, _ in zeros)
                and all(r <= (1e-4 if fp32 else BF16_NOISE_BIAS)
                        for r, _ in biases))
        if fp32:
            good &= all(r <= 1e-4 for r, _ in scores)
        else:
            good &= all(c >= (BF16_COS_IMAGE if n.startswith("image.")
                              else BF16_COS) for c, n in scores)
        out["fp32" if fp32 else "bf16"] = {
            "loss_kernel": lk, "loss_plain": lp, "loss_rel": rel,
            "worst_image": _worst(scores, True),
            "worst_rest": _worst(scores, False),
            "worst_noise_bias": _worst(biases),
            "exact_zero_worst": _worst(zeros), "ok": good}
        ok &= good
        del gk, gp
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    return ok, out


def _hf_flag_check(model, cfg, mb, key):
    """Train-mode losses of one microbatch with ``hf_internal_dropout``
    twice from the same key and once without: (changes, repeats)."""
    import torch

    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)
    from garbage_classification_rca_tpu_torch.train.loss import (
        cross_entropy_loss_and_weight)

    x = normalize_on_device(mb["image"], dtype=torch.bfloat16)
    losses = []
    for flag in (True, True, False):
        model.cfg = dataclasses.replace(cfg, hf_internal_dropout=flag)
        with torch.no_grad():
            logits = model(mb["input_ids"], mb["attention_mask"], x,
                           train=True, key=key)
        losses.append(float(cross_entropy_loss_and_weight(
            logits, mb["label"], None, 0.0, mb["valid"])[0]))
    model.cfg = cfg
    return losses[0] != losses[2], losses[0] == losses[1]


def check_fusion_train(device, results):
    """Every late-fusion pair the JAX package trains but MM-RCA on
    DistilBERT (``FUSION_TRAIN_PAIRS``), at full width on towers built once
    and restored to their seeded weights for each pair: fp32 master
    weights, bf16 images at 480x480, seq 64, batch 16 x acc 2 (MM_RCA.sh's
    acc 10, cut), SGD lr 0.0016 reg 0.03, class weights, augmentation
    p=1.0, head dropout 0.6, stochastic depth, all trainable. Per pair: one
    microbatch's loss and gradients on the kernel path against the plain
    path (``compare_fusion_train_paths``), then one optimizer step with
    the counters zeroed before and read after (``fusion_train_launches``),
    its samples/s, peak memory, and a profiled step (device ms, idle share,
    time by kind). On ``FUSION_HF_PAIRS`` one more step with
    ``hf_internal_dropout`` (K7a / K7b in place of K4a / K4b) and the
    flag's loss against the flag-off one from the same key (it must change
    the loss and repeat)."""
    import torch

    from garbage_classification_rca_tpu_torch.data.augment import (
        augment_batch)
    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)
    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        get_tokenizer)
    from garbage_classification_rca_tpu_torch.models.fusion import multimodal
    from garbage_classification_rca_tpu_torch.nn.core import Key
    from garbage_classification_rca_tpu_torch.train.loop import (
        make_train_step)
    from garbage_classification_rca_tpu_torch.train.optim import (
        make_optimizer)

    t0 = time.perf_counter()
    towers = _fusion_train_towers(device)
    seeded = {k: {n: t.detach().clone() for n, t in v.state_dict().items()}
              for k, v in towers.items()}
    stacks = {}
    for i, (tower, vocab) in enumerate((("distilbert", "wordpiece"),
                                        ("bart", "bpe"))):
        tok = get_tokenizer(tower, vocab_dir=f"tests/fixtures/vocab/{vocab}")
        stacks[tower] = _train_stack(tok, FUSION_TRAIN_ACC, TRAIN_BATCH,
                                     SEED + 310 + i, device)
    stacks["bert"] = stacks["distilbert"]
    class_weights = torch.tensor([0.8, 1.1, 0.9, 1.3], device=device)
    resident = torch.cuda.memory_allocated(device)
    print(f"  towers, seeded copies and data in "
          f"{time.perf_counter() - t0:.1f} s, {resident / 2**30:.2f} GiB "
          f"resident", flush=True)

    def batch_to_inputs(mb, key):
        x = augment_batch(mb["image"], 1.0, key.generator(device))
        return (mb["input_ids"], mb["attention_mask"],
                normalize_on_device(x, dtype=torch.bfloat16))

    ok, out, total, total_hf = True, {}, {}, {}
    profiled = set()       # a profiled step on each tower's first pair only
    for i, (tower, strategy) in enumerate(FUSION_TRAIN_PAIRS):
        t1 = time.perf_counter()
        cfg = multimodal.FusionConfig(strategy=strategy,
                                      text_model_name=tower, reverse=True,
                                      batch_size=TRAIN_BATCH,
                                      image_or_text_dropout_chance=0.0)
        model = _fusion_heads(cfg, SEED + 320 + i).to(device)
        model.text, model.image = towers[tower], towers["image"]
        for name in ("image", tower):
            towers[name].load_state_dict(seeded[name])
        stack = stacks[tower]
        key = Key(SEED + 340 + i)
        mb = {k: v[0] for k, v in stack.items()}
        t_check = time.perf_counter()
        good, checks = compare_fusion_train_paths(model, cfg, mb,
                                                  class_weights, key)
        t_check = time.perf_counter() - t_check
        step = make_train_step(
            model, make_optimizer("sgd", model.named_parameters(), 0.0016,
                                  0.03, None),
            batch_to_inputs=batch_to_inputs, class_weights=class_weights)
        wall, losses, launches, peak = _timed_steps([step], stack,
                                                    key.fold_in(1), device)
        want = fusion_train_launches(tower, strategy, FUSION_TRAIN_ACC)
        t_prof = time.perf_counter()
        if tower in profiled:
            prof = {"device_ms_per_step": None, "idle_share": None,
                    "by_kind_ms": {}}
        else:
            profiled.add(tower)
            prof = profile_train_step(step, stack, key.fold_in(2),
                                      quiet=True)
        t_prof = time.perf_counter() - t_prof
        good &= launches == want and all(l == l for l in losses)
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        samples = FUSION_TRAIN_ACC * TRAIN_BATCH
        row = {"samples_per_s": samples / wall, "step_ms": wall * 1e3,
               "device_ms": prof["device_ms_per_step"],
               "idle_share": prof["idle_share"], "peak_gib": peak / 2**30,
               "by_kind_ms": prof["by_kind_ms"], "loss": losses[0],
               "grad_check": checks, "launches": _shown(launches)}
        if (tower, strategy) in FUSION_HF_PAIRS:
            model.cfg = dataclasses.replace(cfg, hf_internal_dropout=True)
            _zero_counters()
            loss_hf = float(step(stack, key.fold_in(3))[0])
            torch.cuda.synchronize()
            hf_launches = _read_counters()
            model.cfg = cfg
            changes, repeats = _hf_flag_check(model, cfg, mb, key.fold_in(4))
            good &= (hf_launches == fusion_train_launches(
                tower, strategy, FUSION_TRAIN_ACC, dropout=True)
                and loss_hf == loss_hf and changes and repeats)
            total_hf = {k: total_hf.get(k, 0) + v
                        for k, v in hf_launches.items()}
            row["hf_internal_dropout"] = {
                "loss": loss_hf, "launches": _shown(hf_launches),
                "changes_the_loss": changes, "repeats": repeats}
        row["ok"] = good
        ok &= good
        out[f"{strategy}_{tower}"] = row
        kinds = ", ".join(f"{k} {v:.1f}" for k, v in list(
            prof["by_kind_ms"].items())[:5])
        dev_s = (f"device {row['device_ms']:.1f} ms, idle "
                 f"{row['idle_share']:.3f}, " if row["device_ms"] is not None
                 else "not profiled, ")
        print(f"  {strategy} on {tower}: {row['samples_per_s']:.1f} train "
              f"samples/s ({wall * 1e3:.1f} ms a step of "
              f"{FUSION_TRAIN_ACC} x {TRAIN_BATCH}), {dev_s}"
              f"peak {row['peak_gib']:.2f} GiB; by kind (ms): {kinds}; "
              f"launches {_shown(launches)} (want {_shown(want)}); kernel "
              f"vs plain fp32 loss rel {checks['fp32']['loss_rel']:.2e} "
              f"worst {checks['fp32']['worst_rest'][:1]} image "
              f"{checks['fp32']['worst_image'][:1]}, bf16 loss rel "
              f"{checks['bf16']['loss_rel']:.2e} worst "
              f"{checks['bf16']['worst_rest'][:1]} image "
              f"{checks['bf16']['worst_image'][:1]}"
              + (f"; hf_internal_dropout {row['hf_internal_dropout']}"
                 if "hf_internal_dropout" in row else "")
              + f" ({time.perf_counter() - t1:.1f} s: the check "
              f"{t_check:.1f}, the profiled step {t_prof:.1f}) "
              f"{'ok' if good else 'FAIL'}", flush=True)
        model.text = model.image = None
        del model, step
        torch.cuda.empty_cache()
    del towers, seeded, stacks
    torch.cuda.empty_cache()
    results["fusion_train"] = out
    results["fusion_train_launches"] = total
    results["fusion_train_hf_launches"] = total_hf
    print(f"  fusion_train launches over the {len(FUSION_TRAIN_PAIRS)} "
          f"steps: {_shown(total)}; with hf_internal_dropout: "
          f"{_shown(total_hf)}; phase 14's steps in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return ok


def check_fusion_train_clis(device, results):
    """``cli.main_both --late_fusion=hierarchical --text_model=bert``,
    ``cli.main_both --late_fusion=clip --text_model=bart --batch_size=16``
    and ``cli.main_text --text_model=bart`` for 1 + 1 epochs on a synthetic
    480x480 JPEG tree (32 train, 32 val), fp32 with TF32 off, with their
    launches counted; then ``cli.test_both`` / ``cli.test_text``
    ``evaluate()`` on each BEST file, whose accuracy must equal the
    trainer's best val accuracy (the same weights, batches and dtype; the
    test CLI folds BN). In this process, in a work directory of the
    checkout, deleted afterwards."""
    import glob
    import json as _json
    import os
    import shutil

    import torch

    from garbage_classification_rca_tpu_torch.cli import (
        main_both, main_text, test_both, test_text)
    from garbage_classification_rca_tpu_torch.config import args_parser

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_fusion_train_clis")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    vocab = os.path.join(here, "tests", "fixtures", "vocab")
    both = ["--dataset_folder_name=garbage", "--epochs=1", "--ft_epochs=1",
            "--batch_size=16", "--batch_size_FT=16", "--acc_steps=2",
            "--acc_steps_FT=2", "--prob_aug=1.0", "--opt=sgd",
            "--lr=0.0016", "--reg=0.03", "--fraction_lr=3",
            "--balance_weights", "--image_text_dropout=0.0", "--reverse",
            "--compute_dtype=float32"]
    # per run: 2 steps of 2 microbatches; main_both's val: 3 evals a
    # epoch of one batch of 32; the test CLI: one batch of 32 (fp32: K2 on
    # the CUDA cores)
    runs = (
        ("hierarchical_bert", main_both, test_both,
         ["--late_fusion=hierarchical", "--text_model=bert",
          f"--vocab_dir={vocab}/wordpiece"],
         {"mha_fwd_lse": 48, "mha_flash_bwd_tc32": 48, "mha": 72},
         {"mha": 12}),
        ("clip_bart", main_both, test_both,
         ["--late_fusion=clip", "--text_model=bart", "--batch_size=16",
          f"--vocab_dir={vocab}/bpe"], {}, {}),
        ("bart", main_text, test_text,
         ["--text_model=bart", "--seq_len=64",
          f"--vocab_dir={vocab}/bpe"], {}, {}))
    out, ok = {}, True
    cwd = os.getcwd()
    torch.backends.cudnn.allow_tf32 = False
    try:
        _write_jpeg_tree(os.path.join(work, "garbage"), 32, 32, SEED + 350)
        os.chdir(work)
        for name, trainer, tester, flags, want_train, want_test in runs:
            argv = (both if trainer is main_both else [
                "--dataset_folder_name=garbage", "--epochs=1",
                "--ft_epochs=1", "--batch_size=16", "--batch_size_FT=16",
                "--opt=sgd", "--balance_weights"]) + flags
            _zero_counters()
            t0 = time.perf_counter()
            best = trainer.main(argv + [f"--name={name}"])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = _read_counters()
            rows = [_json.loads(line)
                    for f in glob.glob(f"runs/{name}_*.jsonl")
                    for line in open(f)]
            test_argv = [a for a in argv if a.startswith((
                "--late_fusion", "--text_model", "--batch_size=",
                "--vocab_dir", "--seq_len", "--reverse"))] + [
                f"--model_path={best.best_path}",
                "--dataset_folder_name=garbage_Val",
                "--compute_dtype=float32"]
            _zero_counters()
            t0 = time.perf_counter()
            acc, _, preds = tester.evaluate(args_parser(test_argv))[:3]
            torch.cuda.synchronize()
            test_s = time.perf_counter() - t0
            test_launches = _read_counters()
            good = (len(rows) == 2
                    and all(r["avg_loss"] == r["avg_loss"] for r in rows)
                    and {r["phase"] for r in rows} == {"train", "fine_tune"}
                    and launches == _want_launches(**want_train)
                    and test_launches == _want_launches(**want_test)
                    and os.path.isfile(best.best_path) and len(preds) == 32
                    and acc == best.best_val_acc)
            print(f"  cli.{trainer.__name__.rsplit('.', 1)[-1]} {name} 1+1 "
                  f"epochs in {train_s:.1f} s: "
                  f"{[(r['phase'], round(r['avg_loss'], 4), r['val_acc']) for r in rows]}"
                  f", launches {_shown(launches)}; BEST "
                  f"{os.path.basename(best.best_path)} in cli."
                  f"{tester.__name__.rsplit('.', 1)[-1]} in {test_s:.1f} s: "
                  f"accuracy {acc:.2f} % (trainer's best {best.best_val_acc:.2f}"
                  f" %), launches {_shown(test_launches)} "
                  f"{'ok' if good else 'FAIL'}", flush=True)
            out[name] = {"train_s": train_s, "test_s": test_s, "rows": rows,
                         "test_acc": acc, "best_val_acc": best.best_val_acc,
                         "ok": good}
            ok &= good
    finally:
        torch.backends.cudnn.allow_tf32 = True
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    results["fusion_train_clis"] = out
    return ok


# ---------------------------------------------------------------------------
# phase 15: the text family (GPT-2 and MobileBERT, the last two text
# backbones; no hand-written kernel runs on either)
# ---------------------------------------------------------------------------

# (name, fixture vocabulary or None: the hash tokenizer, whose GPT-2 rows
# carry the real pad 50256; the repository holds no GPT-2 vocabulary)
FAMILY = (("gpt2", None), ("mobilebert", "wordpiece"))
FAMILY_BATCHES = 4          # timed eval batches at TEXT_ARCHS' eval batch
FAMILY_CPU_SAMPLES = 8      # the fp32 card-against-CPU check


def _family_tok(name, vocab):
    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        get_tokenizer)

    return get_tokenizer(name, vocab_dir=vocab and
                         f"tests/fixtures/vocab/{vocab}")


def _family_data(name, vocab, n_batches, batch, seed):
    words = [w for w in _family_tok("bert", "wordpiece").vocab if w.isalpha()]
    return SyntheticEvalBatcher(n_batches, batch, seed,
                                tokenizer=_family_tok(name, vocab),
                                seq_len=TEXT_SEQ, words=words)


def _family_train(name, model, data, device, out):
    """One timed step of the recipe's envelope (fp32 masters, all
    trainable, SGD) with the flag off (two steps after a warm-up, then a
    device profile) and on (one step): launches must be 0."""
    import numpy as np
    import torch

    from garbage_classification_rca_tpu_torch.cli.main_text import (
        train_forward)
    from garbage_classification_rca_tpu_torch.nn.core import Key
    from garbage_classification_rca_tpu_torch.train.loop import (
        make_train_step)
    from garbage_classification_rca_tpu_torch.train.optim import (
        make_optimizer)

    stack = {k: torch.from_numpy(np.stack([b[k] for b in data.batches]))
             .to(device) for k in data.batches[0]}
    acc, batch = stack["label"].shape
    key = Key(SEED + 400)
    ok, launches = True, {}
    for flag in (False, True):
        opt = make_optimizer("sgd", model.named_parameters(), UNIMODAL_LR,
                             UNIMODAL_REG)
        step = make_train_step(model, opt, batch_to_inputs=lambda mb, k: (
            mb["input_ids"], mb["attention_mask"]),
            forward=train_forward(model, flag))
        float(step(stack, key.fold_in(9))[0])                   # warm-up
        steps = (step,) if flag else (step, step)
        wall, losses, seen, peak = _timed_steps(steps, stack, key, device)
        for k, v in seen.items():
            launches[k] = launches.get(k, 0) + v
        good = (seen == _want_launches()
                and all(l == l and abs(l) < float("inf") for l in losses))
        ok &= good
        row = {"wall_ms_per_step": wall / len(steps) * 1e3,
               "samples_per_s": len(steps) * acc * batch / wall,
               "peak_mem_gib": peak / 2**30, "losses": losses}
        if not flag:
            row["profile"] = profile_train_step(step, stack, key, reps=1,
                                                acc_steps=acc)
        out["train_flag_on" if flag else "train"] = row
        print(f"  {name} train step, {acc} x {batch}, hf_internal_dropout="
              f"{flag}: {row['wall_ms_per_step']:.1f} ms a step, "
              f"{row['samples_per_s']:.1f} samples/s, peak "
              f"{row['peak_mem_gib']:.2f} GiB, losses {losses}, launches "
              f"{_shown(seen)} (want none) {'ok' if good else 'FAIL'}",
              flush=True)
        del opt, step
    return ok, launches


def check_text_family(device, results):
    """Phase 15's model runs: per model the fp32 card-against-CPU check,
    bf16 ``run_eval`` with ``cli.test_text``'s step at its eval batch
    (launches, samples/s, p50, peak memory, profile), bf16 against fp32,
    and the train step (``_family_train``)."""
    import copy

    import torch

    from garbage_classification_rca_tpu_torch.cli.test_text import (
        make_text_eval_step)
    from garbage_classification_rca_tpu_torch.config import TEXT_ARCHS
    from garbage_classification_rca_tpu_torch.eval.harness import run_eval
    from garbage_classification_rca_tpu_torch.models.registry import (
        get_text_model)

    keys = ("input_ids", "attention_mask", "label", "valid")
    ok, total, out = True, {}, {}
    t0 = time.perf_counter()
    for i, (name, vocab) in enumerate(FAMILY):
        spec = TEXT_ARCHS[name]
        row = out[name] = {}
        cpu = get_text_model(name).build(
            4, generator=torch.Generator().manual_seed(SEED + 410 + i)).eval()
        model32 = copy.deepcopy(cpu).to(device)
        depth = len(model32.layers)
        small = _family_data(name, vocab, 1, FAMILY_CPU_SAMPLES,
                             SEED + 420 + i).batches[0]
        l_card = _text_logits(model32, small, torch.float32).cpu()
        with torch.inference_mode():
            l_cpu = cpu(torch.from_numpy(small["input_ids"]),
                        torch.from_numpy(small["attention_mask"])).float()
        del cpu
        rel = float((l_card - l_cpu).abs().max() / l_cpu.abs().max())
        good = (rel <= 1e-4 and bool(torch.isfinite(l_card).all())
                and tuple(l_card.shape) == (FAMILY_CPU_SAMPLES, 4))
        ok &= good
        row["fp32_card_vs_cpu"] = rel
        print(f"  {name} ({depth} layers): fp32 card vs CPU on "
              f"{FAMILY_CPU_SAMPLES} samples, max|d| / max|logit| = "
              f"{rel:.3e} {'ok' if good else 'FAIL'}", flush=True)

        data = _family_data(name, vocab, FAMILY_BATCHES, spec.eval_batch,
                            SEED + 430 + i)
        l32 = _text_logits(model32, data.batches[0], torch.float32)
        model16 = copy.deepcopy(model32).to(torch.bfloat16)

        def run(model):
            return run_eval(make_text_eval_step(model), data,
                            spec.eval_batch, device, keys=keys,
                            progress=False)

        run(model16)                                        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        rates, p50s = [], []
        for r in range(3):
            _zero_counters()
            _, _, preds, stats = run(model16)
            torch.cuda.synchronize()
            seen = _read_counters()
            for k, v in seen.items():
                total[k] = total.get(k, 0) + v
            good = (seen == _want_launches()
                    and len(preds) == FAMILY_BATCHES * spec.eval_batch)
            ok &= good
            rates.append(stats["samples_per_s"])
            p50s.append(stats["p50_step_s"] * 1e3)
        peak = torch.cuda.max_memory_allocated(device)
        print(f"  {name} run_eval x3 over {FAMILY_BATCHES} batches of "
              f"{spec.eval_batch}, bf16: samples/s {sorted(rates)}, p50 "
              f"batch ms {sorted(p50s)}, peak {peak / 2**30:.2f} GiB; "
              f"launches every run {_shown(seen)} (want none)", flush=True)
        row.update(samples_per_s=sorted(rates)[1], samples_per_s_runs=rates,
                   p50_batch_ms=sorted(p50s)[1], p50_runs_ms=p50s,
                   peak_mem_gib=peak / 2**30, batch=spec.eval_batch,
                   batches=FAMILY_BATCHES, layers=depth,
                   profile=profile_step(make_text_eval_step(model16),
                                        data.batches[0], device))
        l16 = _text_logits(model16, data.batches[0], torch.bfloat16)
        within, agr = bf16_vs_fp32(l16, l32)
        ok &= bool(torch.isfinite(l16).all())
        row["bf16_vs_fp32"] = dict(agr, within_phase10_bar=within)
        print(f"  {name} bf16 vs fp32 on {agr['samples']} samples: max|d|="
              f"{agr['max_logit_diff']:.3e} (max|logit| "
              f"{agr['max_abs_logit']:.3f}), near ties {agr['excluded']} "
              f"(fp32 top-2 margin under 2 max|d|), argmax agreement "
              f"{agr['agreement']} above them, {agr['agreement_all']:.4f} "
              f"over all (recorded; phase 10's bar would "
              f"{'hold' if within else 'not hold'})", flush=True)
        del model16
        torch.cuda.empty_cache()

        train = _family_data(name, vocab, max(1, spec.acc_steps),
                             spec.ft_batch, SEED + 440 + i)
        good, seen = _family_train(name, model32, train, device, row)
        ok &= good
        for k, v in seen.items():
            total[k] = total.get(k, 0) + v
        del model32
        torch.cuda.empty_cache()
    results["text_family_launches"] = total
    out["phase_seconds"] = time.perf_counter() - t0
    results["text_family"] = out
    print(f"  launches over phase 15's model runs: {_shown(total)} (want "
          f"none); in {out['phase_seconds']:.1f} s", flush=True)
    return ok


def check_text_family_clis(device, results):
    """``cli.main_text --hf_internal_dropout`` for 1 + 1 epochs (16 a
    batch) per model on a 32 + 32 tree of drawn texts, launches counted,
    then
    ``cli.test_text`` on its BEST file: ``evaluate()`` in fp32 must give
    the trainer's best val accuracy, ``main()`` a report that carries it
    (``drive_eval_main``), and ``--param_dtype=bfloat16
    --compute_dtype=float32`` must evaluate on bf16 weights. In this
    process, in a work directory of the checkout, deleted afterwards."""
    import glob
    import json as _json
    import os
    import shutil

    import torch

    from garbage_classification_rca_tpu_torch.cli import main_text, test_text
    from garbage_classification_rca_tpu_torch.config import args_parser

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_text_family_clis")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out, ok, total = {}, True, results["text_family_launches"]
    cwd = os.getcwd()
    step_of = test_text.make_text_eval_step
    try:
        # texts drawn per file: the class's two words alone give four
        # distinct inputs, on which a random model can score 0% (no BEST)
        _write_jpeg_tree(os.path.join(work, "garbage"), 32, 32, SEED + 450,
                         size=32, vocab=[w for w in _family_tok(
                             "bert", "wordpiece").vocab if w.isalpha()])
        os.chdir(work)
        for name, vocab in FAMILY:
            flags = [f"--text_model={name}", "--seq_len=64"] + (
                [f"--vocab_dir={here}/tests/fixtures/vocab/{vocab}"]
                if vocab else [])
            _zero_counters()
            t0 = time.perf_counter()
            best = main_text.main(flags + [
                "--dataset_folder_name=garbage", "--epochs=1",
                "--ft_epochs=1", "--batch_size=16", "--batch_size_FT=16",
                "--opt=sgd", "--balance_weights", "--hf_internal_dropout",
                f"--name={name}"])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            rows = [_json.loads(line)
                    for f in glob.glob(f"runs/{name}_*.jsonl")
                    for line in open(f)]
            if best.best_path is None:
                print(f"  cli.main_text {name}: no BEST file (val accuracy "
                      f"0 in every epoch) FAIL", flush=True)
                ok = False
                continue
            test_argv = flags + [f"--model_path={best.best_path}",
                                 "--dataset_folder_name=garbage_Val"]
            t0 = time.perf_counter()
            acc, _, preds = test_text.evaluate(args_parser(
                test_argv + ["--compute_dtype=float32"]))[:3]
            torch.cuda.synchronize()
            test_s = time.perf_counter() - t0
            main_ok, report = drive_eval_main(
                test_text, test_argv + ["--compute_dtype=float32"], acc)
            dtypes = set()

            def recording(model):
                dtypes.update(p.dtype for p in model.parameters())
                return step_of(model)

            test_text.make_text_eval_step = recording
            acc16, _, preds16 = test_text.evaluate(args_parser(
                test_argv + ["--param_dtype=bfloat16",
                             "--compute_dtype=float32"]))[:3]
            test_text.make_text_eval_step = step_of
            torch.cuda.synchronize()
            seen = _read_counters()
            for k, v in seen.items():
                total[k] = total.get(k, 0) + v
            good = (len(rows) == 2
                    and all(r["avg_loss"] == r["avg_loss"] for r in rows)
                    and {r["phase"] for r in rows} == {"train", "fine_tune"}
                    and seen == _want_launches() and main_ok
                    and len(preds) == len(preds16) == 32
                    and acc == best.best_val_acc
                    and dtypes == {torch.bfloat16})
            print(f"  cli.main_text {name} --hf_internal_dropout 1+1 epochs "
                  f"in {train_s:.1f} s: "
                  f"{[(r['phase'], round(r['avg_loss'], 4), r['val_acc']) for r in rows]}"
                  f"; BEST {os.path.basename(best.best_path)} in "
                  f"cli.test_text in {test_s:.1f} s: accuracy {acc:.2f} % "
                  f"(trainer's best {best.best_val_acc:.2f} %), report "
                  f"{report}; --param_dtype=bfloat16 --compute_dtype="
                  f"float32: weights {sorted(map(str, dtypes))}, accuracy "
                  f"{acc16:.2f} %; launches {_shown(seen)} (want none) "
                  f"{'ok' if good else 'FAIL'}", flush=True)
            out[name] = {"train_s": train_s, "test_s": test_s, "rows": rows,
                         "test_acc": acc, "best_val_acc": best.best_val_acc,
                         "bf16_weights_acc": acc16, "report": report,
                         "ok": good}
            ok &= good
    finally:
        test_text.make_text_eval_step = step_of
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    results["text_family_clis"] = out
    return ok


# ---------------------------------------------------------------------------
# phase 16: the conv backbones' training (cuDNN convolutions, no
# hand-written kernel) and RESUME of the engine trainers
# ---------------------------------------------------------------------------

CONV_TRAIN_ACC = 2          # microbatches a step: the recipes' 0 to 24, cut
CONV_PHASE1 = ("shuffle_net", "res18", "res50", "res152", "mb", "convnext")
CONV_CPU_CHECK = ("res18", "shuffle_net", "mb", "convnext", "b0")
# the models whose step is profiled: the BASELINE model and the MM-RCA
# image tower (profiling all twelve costs the script ~20 s)
CONV_PROFILED = ("shuffle_net", "eff_v2_medium")
CONV_CPU_SAMPLES = 2
CONV_CPU_BAR = 1e-4         # |d| over the tensor's largest |g| (or value)
# the towers whose fp32 gradients are held to CONV_CPU_BAR as well as
# their fp64 ones: GELU (ConvNeXt) and SiLU (EfficientNet) are smooth, so
# rounding moves their gradients by rounding only. ReLU, hard-swish and
# max pooling have kinks: an element within an ulp of one takes the other
# branch when the sum runs in another order, and with 2 samples a flipped
# element moves a weight's gradient by percents, on the CPU against itself
# too (ResNet-18 3.5%, ShuffleNetV2 20%, MobileNetV3 1.2% at 2 threads
# against 8). In fp64 no element comes that close: the towers with
# BatchNorm run in fp64 too (ConvNeXt has none, and no kink).
CONV_FP32_GRADS = ("convnext", "b0")

def _conv_stack(name, batch, acc, seed, device):
    """[acc, batch, H, W, 3] uint8 images at `name`'s input size, labels
    over the 4 classes, every sample valid, on the device."""
    import numpy as np
    import torch

    from garbage_classification_rca_tpu_torch.config import IMAGE_ARCHS

    h, w = IMAGE_ARCHS[name].input_size
    g = torch.Generator(device=device).manual_seed(seed)
    return {"image": torch.randint(0, 256, (acc, batch, h, w, 3),
                                   dtype=torch.uint8, device=device,
                                   generator=g),
            "label": torch.from_numpy(np.random.default_rng(seed).integers(
                0, 4, (acc, batch)).astype(np.int32)).to(device),
            "valid": torch.ones((acc, batch), dtype=torch.int32,
                                device=device)}


def _conv_step(model, trainable=None):
    """``cli.main_image``'s step: augmentation at its default p on the
    step key's stream, bf16 images, SGD over the fp32 masters, class
    weights."""
    import torch

    from garbage_classification_rca_tpu_torch.config import RunConfig
    from garbage_classification_rca_tpu_torch.data.augment import (
        augment_batch)
    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)
    from garbage_classification_rca_tpu_torch.train.loop import (
        make_train_step)
    from garbage_classification_rca_tpu_torch.train.optim import (
        make_optimizer)

    p = RunConfig().prob_aug

    def batch_to_inputs(mb, key):
        x = augment_batch(mb["image"], p, key.generator(mb["image"].device))
        return (normalize_on_device(x, dtype=torch.bfloat16),)

    opt = make_optimizer("sgd", model.named_parameters(), UNIMODAL_LR,
                         UNIMODAL_REG, trainable)
    weights = torch.tensor([0.8, 1.1, 0.9, 1.3],
                           device=next(model.parameters()).device)
    return make_train_step(model, opt, batch_to_inputs=batch_to_inputs,
                           class_weights=weights)


def _conv_timed_step(name, step, stack, key, device, profile):
    """A warm-up step, then one timed with the counters zeroed before and
    read after (each must read 0), and with `profile` one profiled: the
    numbers of the step."""
    import torch

    t0 = time.perf_counter()
    float(step(stack, key.fold_in(99))[0])                  # warm-up
    warm = time.perf_counter() - t0
    wall, losses, launches, peak = _timed_steps((step,), stack, key, device)
    acc, batch = stack["label"].shape
    row = {"microbatch": batch, "acc_steps": acc, "step_ms": wall * 1e3,
           "samples_per_s": acc * batch / wall, "peak_mem_gib": peak / 2**30,
           "loss": losses[0], "warmup_s": warm}
    if profile:
        t0 = time.perf_counter()
        prof = profile_train_step(step, stack, key.fold_in(7), reps=1,
                                  kind=_conv_kind, quiet=True)
        row.update(device_ms_per_step=prof["device_ms_per_step"],
                   idle_share=prof["idle_share"],
                   by_kind_ms=prof["by_kind_ms"],
                   profile_s=time.perf_counter() - t0)
    ok = (launches == _want_launches() and losses[0] == losses[0]
          and abs(losses[0]) < float("inf"))
    torch.cuda.empty_cache()
    return ok, row, launches


def _conv_grads(model, x, label, valid, dev):
    """(loss, {name: grad}, {name: buffer}) of one train microbatch of
    `model` on `dev` (no key: no random draw), `x` its normalized NHWC
    input in the model's dtype."""
    import torch

    from garbage_classification_rca_tpu_torch.train.loss import (
        cross_entropy_loss_and_weight)

    with torch.enable_grad():
        loss, _ = cross_entropy_loss_and_weight(
            model(x.to(dev), train=True), label.to(dev), None, 0.0,
            valid.to(dev))
        loss.backward()
    return (float(loss.detach()),
            {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: b.cpu() for n, b in model.named_buffers()})


def _grad_scales(g64):
    """What each gradient's |d| is sized against: its tensor's largest
    |g| in the CPU's fp64 run, or, for a BatchNorm bias whose fp64
    gradient is rounding noise (below 1e-9 of its scale's: zero in exact
    arithmetic, where a train-mode BN after the next conv removes a
    per-channel shift), its scale's largest |g|."""
    mx = {n: float(g.abs().max()) for n, g in g64.items()}
    out = {}
    for n, m in mx.items():
        partner = mx.get(n[:-4] + "scale") if n.endswith("bn.bias") else None
        out[n] = partner if partner and m <= 1e-9 * partner else m
    return out


def _grad_ratios(got, want, scales):
    """Each gradient's largest |d| over its `scales` entry, sorted."""
    return sorted(((float((g.double() - want[n].double()).abs().max())
                    / max(scales[n], 1e-300), n) for n, g in got.items()),
                  reverse=True)


def _conv_card_vs_cpu(name, seed, device):
    """One train microbatch of `name` (no random draw) on the card and on
    the CPU from the same weights, in fp32 with TF32 off and, for a
    tower with BatchNorm, in fp64: (ok, numbers). Every fp64 gradient
    within CONV_CPU_BAR of its tensor's largest |g| (``_grad_scales``;
    the ops the port sums in fp32 by design, LayerNorm, the pooled means
    and the loss, stay fp32 there); in fp32 the loss within
    CONV_CPU_BAR relative, the new running statistics within CONV_CPU_BAR
    of their largest value, and on the CONV_FP32_GRADS towers every
    gradient within CONV_CPU_BAR as in fp64 (on the others the fp32
    gradients are reported: CONV_FP32_GRADS says why)."""
    import copy

    import numpy as np
    import torch

    from garbage_classification_rca_tpu_torch.config import IMAGE_ARCHS
    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)
    from garbage_classification_rca_tpu_torch.models.registry import (
        get_image_model)
    from garbage_classification_rca_tpu_torch.nn.core import BatchNorm

    init = get_image_model(name).build(
        4, generator=torch.Generator().manual_seed(seed))
    _randomize_bn(init, torch.Generator().manual_seed(seed + 1))
    with_bn = any(isinstance(m, BatchNorm) for m in init.modules())
    h, w = IMAGE_ARCHS[name].input_size
    rng = np.random.default_rng(seed + 2)
    x = normalize_on_device(torch.from_numpy(rng.integers(
        0, 256, (CONV_CPU_SAMPLES, h, w, 3), dtype=np.uint8)),
        dtype=torch.float32)
    label = torch.from_numpy(rng.integers(0, 4, CONV_CPU_SAMPLES).astype(
        np.int32))
    valid = torch.ones(CONV_CPU_SAMPLES, dtype=torch.int32)
    dtypes = (torch.float64, torch.float32) if with_bn else (torch.float32,)
    runs = {}
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dt in dtypes:
            runs[str(dt)[6:]] = [_conv_grads(copy.deepcopy(init).to(dev, dt),
                                             x.to(dt), label, valid, dev)
                                 for dev in ("cpu", device)]
    finally:
        torch.backends.cudnn.allow_tf32 = True
    scales = _grad_scales(next(iter(runs.values()))[0][1])
    loss = {k: abs(card[0] - cpu[0]) / abs(cpu[0])
            for k, (cpu, card) in runs.items()}
    grads = {k: _grad_ratios(card[1], cpu[1], scales)
             for k, (cpu, card) in runs.items()}
    held = [k for k in grads if k == "float64" or name in CONV_FP32_GRADS]
    (l32, _, s32), (l32c, _, s32c) = runs["float32"]
    stats = sorted(((float((b - s32[n]).abs().max())
                     / float(s32[n].abs().max()), n)
                    for n, b in s32c.items()), reverse=True)
    finite = all(bool(torch.isfinite(g).all())
                 for _, card in runs.values() for g in card[1].values())
    ok = (finite and all(v <= CONV_CPU_BAR for v in loss.values())
          and all(grads[k][0][0] <= CONV_CPU_BAR for k in held)
          and (not stats or stats[0][0] <= CONV_CPU_BAR))
    out = {"loss_fp32": [l32, l32c], "tensors": len(scales),
           "zero_in_exact_arithmetic": sum(
               scales[n] != float(g.abs().max())
               for n, g in next(iter(runs.values()))[0][1].items()),
           "worst_running_stats": [(float(f"{v:.4g}"), n)
                                   for v, n in stats[:2]]}
    text = []
    for k, g in grads.items():
        out[k] = {"loss_rel_diff": loss[k], "held": k in held,
                  "past_bar": sum(v > CONV_CPU_BAR for v, _ in g),
                  "worst_grads": [(float(f"{v:.4g}"), n) for v, n in g[:3]]}
        text.append(f"{k} loss rel {loss[k]:.2e}, worst gradients "
                    f"{out[k]['worst_grads']} ({out[k]['past_bar']} past "
                    f"the bar, {'held' if k in held else 'reported'})")
    print(f"  {name} train microbatch of {CONV_CPU_SAMPLES}, card vs CPU "
          f"over {len(scales)} tensors: {'; '.join(text)}; fp32 loss "
          f"{l32c:.6f} vs {l32:.6f}, worst running stats "
          f"{out['worst_running_stats']} (bar {CONV_CPU_BAR:g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok, out

def check_conv_train(device, results):
    """Phase 16's model runs: each conv backbone's timed steps
    (``_conv_timed_step``), then the fp64 and fp32 card-against-CPU
    microbatch on each family's smallest member (``_conv_card_vs_cpu``).
    """
    import torch

    from garbage_classification_rca_tpu_torch.cli.main_image import (
        head_keys_for)
    from garbage_classification_rca_tpu_torch.config import IMAGE_ARCHS
    from garbage_classification_rca_tpu_torch.nn.core import Key
    from garbage_classification_rca_tpu_torch.train.loop import (
        head_only_mask)

    ok, out, total = True, {}, {}
    t0 = time.perf_counter()
    for i, name in enumerate(CONV_NAMES):
        t_model = time.perf_counter()
        spec = IMAGE_ARCHS[name]
        model = _conv_model(name, SEED + 500 + 2 * i, device)
        built = time.perf_counter() - t_model
        key = Key(SEED + 540 + i)
        runs = [("all", spec.ft_batch, None)]
        if name in CONV_PHASE1:
            runs.append(("phase1", spec.train_batch, head_only_mask(
                model, head_keys_for(name))))
        row = out[name] = {"input_size": spec.input_size}
        for what, batch, mask in runs:
            stack = _conv_stack(name, batch, CONV_TRAIN_ACC,
                                SEED + 560 + i, device)
            good, nums, seen = _conv_timed_step(
                name, _conv_step(model, mask), stack, key, device,
                profile=what == "all" and name in CONV_PROFILED)
            for k, v in seen.items():
                total[k] = total.get(k, 0) + v
            ok &= good
            row[what] = nums
            kinds = nums.get("by_kind_ms", {})
            busy = nums.get("device_ms_per_step")
            split = ", ".join(f"{k} {ms / busy:.1%}" for k, ms in
                              kinds.items()) if busy else ""
            print(f"  {name} {what} step, {CONV_TRAIN_ACC} x {batch} at "
                  f"{spec.input_size[0]}x{spec.input_size[1]}: "
                  f"{nums['step_ms']:.1f} ms, {nums['samples_per_s']:.1f} "
                  f"samples/s, peak {nums['peak_mem_gib']:.2f} GiB"
                  + (f", device {busy:.1f} ms, idle share "
                     f"{nums['idle_share']:.3f} ({split})" if busy else "")
                  + f"; launches {_shown(seen)} (want none) "
                  f"{'ok' if good else 'FAIL'}", flush=True)
            del stack
        del model
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t_model
        print(f"  ({name}: {row['seconds']:.1f} s; build {built:.1f} s, "
              f"first steps " + ", ".join(
                  f"{r['warmup_s']:.1f} s" for w in ("all", "phase1")
                  if (r := row.get(w)))
              + (f", profile {row['all']['profile_s']:.1f} s"
                 if "profile_s" in row["all"] else "") + ")", flush=True)
    checks = {}
    for i, name in enumerate(CONV_CPU_CHECK):
        t_check = time.perf_counter()
        good, checks[name] = _conv_card_vs_cpu(name, SEED + 580 + 3 * i,
                                               device)
        checks[name]["seconds"] = time.perf_counter() - t_check
        print(f"  ({name} card vs CPU: {checks[name]['seconds']:.1f} s)",
              flush=True)
        ok &= good
    torch.cuda.empty_cache()
    results["conv_train_launches"] = total
    results["conv_train"] = {"models": out, "card_vs_cpu": checks,
                             "acc_steps_cut_to": CONV_TRAIN_ACC,
                             "seconds": time.perf_counter() - t0}
    print(f"  phase 16's model runs in {time.perf_counter() - t0:.1f} s; "
          f"launches {_shown(total)} (want none)", flush=True)
    return ok


class _Killed(Exception):
    """What a dying train step raises: a run killed mid-training."""


@contextlib.contextmanager
def _dying_step(cli, at, factory="make_train_step"):
    """`cli`'s steps raise at the `at`-th call over the run. `factory`
    names `cli`'s step maker: it returns the step, or a tuple whose second
    item is the train step (the VLM trainers'). Yields the call counter
    ``{"n": calls so far}``."""
    real, calls = getattr(cli, factory), {"n": 0}

    def make(*a, **kw):
        built = real(*a, **kw)
        step = built[1] if isinstance(built, tuple) else built

        def dying(*sa, **skw):
            calls["n"] += 1
            if calls["n"] == at:
                raise _Killed
            return step(*sa, **skw)

        if isinstance(built, tuple):
            return (built[0], dying) + tuple(built[2:])
        return dying

    setattr(cli, factory, make)
    try:
        yield calls
    finally:
        setattr(cli, factory, real)


def _run_end(model_name):
    """(final RESUME payload, logged rows) of the run in the current
    directory."""
    import glob
    import json as _json
    import os

    import torch

    rows = [_json.loads(line) for f in sorted(glob.glob("runs/*.jsonl"))
            for line in open(f)]
    return (torch.load(os.path.join("model_weights", model_name, "RESUME"),
                       map_location="cpu", weights_only=True), rows)


def _run_gap(a, b):
    """Largest |d| between two runs' final states (model and optimizer
    tensors) and their logged losses; None if they do not line up."""
    import torch

    ta, tb = {}, {}
    for src, dst in ((a[0], ta), (b[0], tb)):
        dst.update({"model." + k: v for k, v in src["state_dict"].items()})
        for i, st in src["optimizer"]["state"].items():
            for k, v in st.items():
                if torch.is_tensor(v):
                    dst[f"opt.{i}.{k}"] = v
    if ta.keys() != tb.keys() or len(a[1]) != len(b[1]):
        return None
    state = max((float((ta[k].double() - tb[k].double()).abs().max())
                 for k in ta), default=0.0)
    loss = max((abs(ra[k] - rb[k]) for ra, rb in zip(a[1], b[1])
                for k in ("avg_loss", "max_loss", "min_loss") if k in ra),
               default=0.0)
    meta = ({k: v for k, v in a[0]["meta"].items() if k != "best_path"} ==
            {k: v for k, v in b[0]["meta"].items() if k != "best_path"})
    return {"state": state, "loss": loss, "meta_equal": meta}


_K_GROUPS = {"K1": ("rca_fused", "rca_fused_per_sample"),
             "K2": ("mha", "mha_tc"),
             "K3": ("rca_fused_bwd", "rca_fused_bwd_per_sample"),
             "K4a": ("mha_fwd_lse", "mha_fwd_lse_tc"),
             "K4b": ("mha_flash_bwd", "mha_flash_bwd_tc",
                     "mha_flash_bwd_tc32")}


def _resume_case(title, cli, argv, model_name, kills, work, want_k=(),
                 factory="make_train_step", resume_flag="--model_path"):
    """`cli` run twice uninterrupted (the control), then, for each (label,
    kill_at) of `kills`, killed at the `kill_at`-th step and resumed from
    its RESUME through `resume_flag`: (ok, {label: numbers}). A resumed
    run must end bit-identical to the first uninterrupted one where the
    two uninterrupted runs are, else no further from it than they are
    from each other; with `want_k`, each of those kernels (``_K_GROUPS``)
    launched in it."""
    import os

    import torch

    ends = []
    for run in ("a", "b"):
        os.makedirs(os.path.join(work, run))
        os.chdir(os.path.join(work, run))
        cli.main(argv)
        ends.append(_run_end(model_name))
    control = _run_gap(ends[0], ends[1])
    bitwise = control is not None and control["state"] == 0.0 \
        and control["loss"] == 0.0
    ok, out = True, {}
    for label, kill_at in kills:
        os.makedirs(os.path.join(work, f"killed_{kill_at}"))
        os.chdir(os.path.join(work, f"killed_{kill_at}"))
        try:
            with _dying_step(cli, kill_at, factory):
                cli.main(argv)
            killed_ok = False                 # the kill never came
        except _Killed:
            killed_ok = True
        meta = _run_end(model_name)[0]["meta"]
        saved = (meta["phase_name"], meta["epoch"], meta["step"])
        _zero_counters()
        t0 = time.perf_counter()
        cli.main(argv + [f"{resume_flag}=model_weights/{model_name}/RESUME"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        seen = _read_counters()
        launches = {k: sum(seen[c] for c in cs)
                    for k, cs in _K_GROUPS.items()}
        gap = _run_gap(ends[0], _run_end(model_name))
        good = (killed_ok and control is not None and gap is not None
                and gap["meta_equal"] and gap["state"] <= control["state"]
                and gap["loss"] <= control["loss"]
                and all(launches[k] > 0 for k in want_k))
        print(f"  {title}, {label}: killed at step call {kill_at}, RESUME "
              f"held (phase, epoch, step) {saved}; resumed run in "
              f"{secs:.1f} s; control (two uninterrupted runs) {control}, "
              f"resumed vs uninterrupted {gap} ("
              f"{'bit-identical required' if bitwise else 'within the control'})"
              + (f"; launches over the resumed run {launches} (want > 0 "
                 f"for {list(want_k)})" if want_k else "")
              + f" {'ok' if good else 'FAIL'}", flush=True)
        out[label] = {"kill_at": kill_at, "resume_held": saved,
                      "control": control, "resumed_vs_uninterrupted": gap,
                      "resumed_s": secs, "resumed_launches": launches,
                      "ok": good}
        ok &= good
    return ok, out


def check_resume(device, results):
    """``cli.main_image --image_model=res18`` for 1 + 1 epochs into
    ``cli.test_image`` (``drive_eval_main`` with the trainer's best val
    accuracy), then RESUME held to a control (``_resume_case``): the res18
    trainer killed at the epoch boundary, ``cli.main_both
    --late_fusion=MM_RCA`` killed mid-epoch under
    ``--resume_every_steps=1``. fp32 images for res18, TF32 off for the
    phase. In a work directory of the checkout, deleted afterwards."""
    import os
    import shutil

    import torch

    from garbage_classification_rca_tpu_torch.cli import (main_both,
                                                          main_image,
                                                          test_image)

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_resume")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    vocab = os.path.join(here, "tests", "fixtures", "vocab", "wordpiece")
    cwd = os.getcwd()
    out, ok = {}, True
    torch.backends.cudnn.allow_tf32 = False
    try:
        _write_jpeg_tree(os.path.join(work, "conv"), 32, 32, SEED + 600,
                         size=224)
        _write_jpeg_tree(os.path.join(work, "mm"), 16, 8, SEED + 601)
        # res18: 32 train samples at 16 x acc 2 are one window an epoch;
        # the 2nd call is the fine_tune epoch's first
        image_argv = [f"--dataset_folder_name={work}/conv",
                      "--image_model=res18", "--epochs=1", "--ft_epochs=1",
                      "--batch_size=16", "--batch_size_FT=16",
                      "--acc_steps=2", "--acc_steps_FT=2", "--opt=sgd",
                      "--balance_weights", "--compute_dtype=float32",
                      "--name=res18"]
        os.makedirs(os.path.join(work, "cli"))
        os.chdir(os.path.join(work, "cli"))
        _zero_counters()
        t0 = time.perf_counter()
        best = main_image.main(image_argv)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = _read_counters()
        test_argv = ["--image_model=res18", f"--model_path={best.best_path}",
                     f"--dataset_folder_name={work}/conv_Val",
                     "--compute_dtype=float32"]
        main_ok, report = drive_eval_main(test_image, test_argv,
                                          best.best_val_acc)
        good = (main_ok and launches == _want_launches()
                and os.path.isfile(best.best_path))
        print(f"  cli.main_image --image_model=res18 1+1 epochs in "
              f"{train_s:.1f} s: best val accuracy {best.best_val_acc:.2f} % "
              f"(epoch {best.best_epoch}); launches {_shown(launches)} (want "
              f"none); its BEST file in cli.test_image: report {report} "
              f"{'ok' if good else 'FAIL'}", flush=True)
        out["main_image_res18"] = {"train_s": train_s, "report": report,
                                   "best_val_acc": best.best_val_acc,
                                   "ok": good}
        ok &= good
        good, cases = _resume_case(
            "cli.main_image res18", main_image, image_argv, "res18",
            [("killed at the epoch boundary", 2)], os.path.join(work, "r18"))
        out["res18_epoch_boundary"] = cases["killed at the epoch boundary"]
        ok &= good
        # MM_RCA: 16 train samples at 4 x acc 2 are 2 windows an epoch;
        # the 4th call is the fine_tune epoch's second window
        both_argv = [f"--dataset_folder_name={work}/mm",
                     "--late_fusion=MM_RCA", "--reverse", "--epochs=1",
                     "--ft_epochs=1", "--batch_size=4", "--batch_size_FT=4",
                     "--acc_steps=2", "--acc_steps_FT=2", "--opt=sgd",
                     "--lr=0.0016", "--reg=0.03", "--fraction_lr=3",
                     "--balance_weights", "--prob_aug=1.0", "--seq_len=64",
                     "--resume_every_steps=1", f"--vocab_dir={vocab}",
                     "--name=mm_rca"]
        good, cases = _resume_case(
            "cli.main_both MM_RCA", main_both, both_argv,
            "MM_RCA_distilbert", [("killed mid-epoch", 4)],
            os.path.join(work, "mm_rca"), want_k=tuple(_K_GROUPS))
        out["mm_rca_mid_epoch"] = cases["killed mid-epoch"]
        ok &= good
    finally:
        torch.backends.cudnn.allow_tf32 = True
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    results["resume"] = out
    return ok


# ---------------------------------------------------------------------------
# phase 17: BLIP-2 generation and serving (KV caches, sampling, int8 cache
# and weights, the continuous-batching server, speculative decoding; K2 in
# every prefill)
# ---------------------------------------------------------------------------

SERVE_BATCH, SERVE_NEW = 16, 32     # generate's batch and new tokens
SERVE_FP32_BATCH = 4
# cli.serve's defaults (config.py): slots, max_prompt, decode steps a sync
SERVE_SLOTS, SERVE_PROMPT, SERVE_SYNC = 8, 100, 8
SERVE_REQUESTS = 24                 # half image, half text
SPEC_DRAFT_K = 4
# facebook/opt-125m config.json: the draft's published widths
OPT_125M = {"layers": 12, "hidden": 768, "heads": 12, "ffn": 3072,
            "vocab": 50272}
SERVE_K2 = {"eva": 39, "opt": 32}   # K2 a BLIP-2 batch's towers / a prefill
# the depth of the JAX package's tests/test_quant.py model, where its int8
# cache bar is held; a random full-depth OPT-2.7B amplifies any
# perturbation (a one-ulp move of its inputs moves the logits ~2% of the
# largest), so full depth is recorded beside that control
SERVE_QUANT_LAYERS = 3

# the int8 witness: OPT-2.7B's widths cut to SERVE_QUANT_LAYERS layers,
# weights and biases N(0, 0.02), LayerNorms (1, 0), as ``blip2.init_``
# draws them, but from numpy, so that the JAX package reads the same model
# on the CPU; `batch` prompts of `tokens` token embeddings, left-padded
INT8_WITNESS = {"seed": SEED + 723, "batch": 16, "tokens": 12}
# what the JAX package reads on it, in fp32 and in bf16 (the model cast,
# then quantized): the first-step logits with int8 weights, max |d| from
# the unquantized model's over its largest |logit| (the JAX test_quant.py
# statistic, which it bars at 0.02 on a 64-wide model).
# tests/test_torch_sampling_quant.py::test_int8_witness_readings computes
# them with the JAX package and holds these values.
INT8_WITNESS_JAX = {"float32": 0.019730020314455032,
                    "bfloat16": 0.022857142612338066}
# the JAX test_quant.py bar, for the int8 cache (one decode step's hidden,
# max |d| from the float cache's over its largest |value|): the JAX
# package reads under it on the witness too (the same test)
INT8_CACHE_BAR = 0.02


def int8_witness_inputs():
    """The witness (``INT8_WITNESS``): (the OPT tree in the JAX layout,
    numpy fp32; token ids [B, T]; mask [B, T] int32, row r left-padded by
    r % 5)."""
    import numpy as np

    from garbage_classification_rca_tpu_torch.models.vlm import opt as o

    cfg = o.OPTConfig(layers=SERVE_QUANT_LAYERS)
    rng = np.random.default_rng(INT8_WITNESS["seed"])
    normal = lambda *shape: rng.standard_normal(
        shape, dtype=np.float32) * np.float32(0.02)
    ln = lambda: {"scale": np.ones(cfg.hidden, np.float32),
                  "bias": np.zeros(cfg.hidden, np.float32)}
    lin = lambda i, j: {"w": normal(i, j), "b": normal(j)}
    h = cfg.hidden
    params = {
        "embed_tokens": {"w": normal(cfg.vocab, h)},
        "embed_positions": {"w": normal(cfg.max_pos + cfg.pos_offset, h)},
        "final_ln": ln(),
        "layers": [{"ln1": ln(), "q": lin(h, h), "k": lin(h, h),
                    "v": lin(h, h), "out": lin(h, h), "ln2": ln(),
                    "fc1": lin(h, cfg.ffn), "fc2": lin(cfg.ffn, h)}
                   for _ in range(cfg.layers)]}
    b, t = INT8_WITNESS["batch"], INT8_WITNESS["tokens"]
    ids = rng.integers(0, cfg.vocab, (b, t))
    mask = np.ones((b, t), np.int32)
    for r in range(b):
        mask[r, :r % 5] = 0
    return params, ids, mask


def int8_witness_readings(params, ids, mask, device, dtype, control=False):
    """The port's readings on the witness, the model cast to `dtype` on
    `device`, then quantized: "weights" (``INT8_WITNESS_JAX``'s statistic)
    and "cache" (``INT8_CACHE_BAR``'s).
    With `control`, also each reading's one-ulp control: the unquantized
    model on the token embeddings moved by N(0, 1) bf16 ulps, from its
    own output."""
    import torch

    from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
        load_jax_tree)
    from garbage_classification_rca_tpu_torch.models.vlm import opt as o
    from garbage_classification_rca_tpu_torch.ops.quant import (
        quantize_opt_weights)

    with torch.device("meta"):
        model = o.OPTDecoder(o.OPTConfig(layers=SERVE_QUANT_LAYERS))
    model = model.to_empty(device="cpu").requires_grad_(False)
    load_jax_tree(model, params)
    model = model.to(device, dtype)
    ids_d = torch.from_numpy(ids).to(device)
    mask_d = torch.from_numpy(mask).to(device)
    b, t = mask.shape
    rel = lambda a, ref: float((a.float() - ref.float()).abs().max()
                               / ref.float().abs().max())
    out = {}
    with torch.inference_mode():
        emb = o.embed_tokens(model, ids_d).to(dtype)
        step = (o.embed_tokens(model, ids_d[:, 0]).to(dtype),
                torch.full((b,), t, device=device),
                mask_d.sum(1) + model.cfg.pos_offset,
                torch.nn.functional.pad(mask_d, (0, 1), value=1))
        lg, caches = _first_logits(model, emb, mask_d, None, 1.0)
        h = o.decode_step(model, caches, *step)[0]
        _, cq = _first_logits(model, emb, mask_d, None, 1.0, "int8")
        out["cache"] = rel(o.decode_step(model, cq, *step)[0], h)
        if control:
            g = torch.Generator(device=device).manual_seed(SEED + 724)
            moved = (emb.float() * (1.0 + 2.0 ** -8 * torch.randn(
                emb.shape, generator=g, device=device))).to(dtype)
            lu, cu = _first_logits(model, moved, mask_d, None, 1.0)
            out["weights_control"] = rel(lu, lg)
            out["cache_control"] = rel(o.decode_step(model, cu, *step)[0],
                                       h)
        quantize_opt_weights(model)
        out["weights"] = rel(_first_logits(model, emb, mask_d, None,
                                           1.0)[0], lg)
    return out


@contextlib.contextmanager
def record_margins(logits=None, keep=2):
    """Every ``opt.lm_head`` call on [R, H] inside: the top-2 margin of
    each row's logits, appended as an fp32 [R] tensor (``generate`` makes
    one call a step); the first `keep` calls' fp32 logits appended to the
    list `logits` where one is given."""
    from garbage_classification_rca_tpu_torch.models.vlm import opt as o

    real, out = o.lm_head, []

    def rec(model, h):
        lg = real(model, h)
        if lg.dim() == 2:
            top = lg.float().topk(2, dim=-1).values
            out.append(top[:, 0] - top[:, 1])
            if logits is not None and len(out) <= keep:
                logits.append(lg.float())
        return lg

    o.lm_head = rec
    try:
        yield out
    finally:
        o.lm_head = real


def near_tie_agree(got, want, margins, floor):
    """Token streams [B, N]: each row of `got` equal to `want` up to the
    first step whose reference margin (`margins` [B, N], `want`'s side) is
    under `floor`. -> (ok, numbers: the streams identical, those cut at a
    near tie, the steps under the floor)."""
    got, want, under = got.cpu(), want.cpu(), (margins.cpu() < floor)
    bad, cut = [], 0
    for r in range(want.shape[0]):
        diff = (got[r] != want[r]).nonzero()
        if not len(diff):
            continue
        if bool(under[r, :int(diff[0]) + 1].any()):
            cut += 1
        else:
            bad.append(r)
    same = int((got == want).all(dim=1).sum())
    return not bad, {"floor": floor, "streams": want.shape[0],
                     "identical": same, "cut_at_a_near_tie": cut,
                     "steps_under_floor": int(under.sum()),
                     "disagreeing": bad}


def _agree_one(got, want, marg, floor):
    """``near_tie_agree`` of one stream (a token list) against its
    reference (tokens and margins, 1-D), the shorter padded."""
    import torch

    got = torch.as_tensor(got, dtype=torch.long)
    want, marg = want.cpu().long(), marg.cpu().float()
    n = max(len(got), len(want))
    pad = lambda t, v: torch.nn.functional.pad(t, (0, n - len(t)), value=v)
    return near_tie_agree(pad(got, -7)[None], pad(want, -9)[None],
                          pad(marg, float("inf"))[None], floor)


def _alone(model_opt, lora, scale, e, m, max_prompt, n_new, budget, eos,
           logits=None):
    """A request's own B = 1 ``generate``, padded on the right to
    `max_prompt` and run for the server's `n_new` tokens as the server's
    caches hold them: (tokens, margins) up to its EOS and its `budget`."""
    import torch

    pad = max_prompt - e.shape[0]
    ee = torch.nn.functional.pad(e, (0, 0, 0, pad))[None]
    mm = torch.nn.functional.pad(m.to(torch.int32), (0, pad))[None]
    toks, vv, marg, _ = _gen(model_opt, ee, mm, lora, scale, n_new,
                             eos_id=eos, logits=logits)
    keep = min(int(vv[0].sum()), budget)
    return toks[0, :keep], marg[0, :keep]


def _stream_line(name, agr):
    return (f"{name}: {agr['identical']} of {agr['streams']} streams "
            f"identical, {agr['cut_at_a_near_tie']} cut at a near tie "
            f"(floor {agr['floor']:.3e}, {agr['steps_under_floor']} steps "
            f"under it)")


def _first_logits(model_opt, embeds, mask, lora, scale, cache_dtype=None):
    """(first-step logits fp32 [B, V], caches) of a prefill."""
    import torch

    from garbage_classification_rca_tpu_torch.models.vlm import opt as o

    h, caches = o.prefill(model_opt, embeds, mask, 1, lora=lora,
                          lora_scale=scale, cache_dtype=cache_dtype)
    lg = o.lm_head(model_opt, o.last_hidden(h, mask.to(torch.int32)))
    return lg.float(), caches


def _first_layers(model_opt, n):
    """The OPT decoder cut to its first `n` layers, at full width, sharing
    the weights (the depth of the JAX package's ``tests/test_quant.py``
    model, for its bars)."""
    from torch import nn

    from garbage_classification_rca_tpu_torch.models.vlm import opt as o

    cut = o.OPTDecoder.__new__(o.OPTDecoder)
    nn.Module.__init__(cut)
    cut.cfg = dataclasses.replace(model_opt.cfg, layers=n)
    cut.embed_tokens = model_opt.embed_tokens
    cut.embed_positions = model_opt.embed_positions
    cut.final_ln = model_opt.final_ln
    cut.layers = nn.ModuleList(list(model_opt.layers)[:n])
    return cut


def _gen(model_opt, embeds, mask, lora, scale, n, plain=False, logits=None,
         **kw):
    """(tokens, valid, margins [B, n], seconds) of ``opt.generate``, on the
    plain versions with `plain`; the first two steps' logits appended to
    `logits` where given."""
    import torch

    from garbage_classification_rca_tpu_torch.models.vlm import opt as o

    ctx = plain_versions() if plain else contextlib.nullcontext()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ctx, record_margins(logits) as marg:
        toks, valid = o.generate(model_opt, embeds, mask, n, lora=lora,
                                 lora_scale=scale, **kw)
    torch.cuda.synchronize()
    return toks, valid, torch.stack(marg, 1), time.perf_counter() - t0


def _serving_prompts(tok, n, seed, t_len):
    """n knowledge prompts around random item words, left-padded to t_len:
    (ids [n, t_len], mask) int32 numpy."""
    import numpy as np

    from garbage_classification_rca_tpu_torch.cli.blip2_common import (
        left_pad)
    from garbage_classification_rca_tpu_torch.models.vlm.prompts import (
        build_prompt)

    rng = np.random.default_rng(seed)
    rows = [left_pad(tok.encode_one(build_prompt(" ".join(rng.choice(
        VLM_ITEMS, rng.integers(1, 4)))), t_len)[0], t_len, tok.pad_id)
        for _ in range(n)]
    return (np.asarray([r[0] for r in rows], np.int32),
            np.asarray([r[1] for r in rows], np.int32))


def _profile_decode(srv, steps):
    """torch.profiler over `steps` decode steps of the server's lanes
    (``_trace``): device ms a step, wall ms a step, idle share, device
    operations a step."""
    srv._decode(steps)                                     # warm
    kinds, _, ops, wall = _trace(lambda r: srv._decode(steps), 1, _kind)
    busy = sum(kinds.values())
    return {"device_ms_per_step": busy / steps,
            "wall_ms_per_step": wall / steps,
            "idle_share": 1.0 - busy / wall,
            "device_ops_per_step": ops / steps}


def check_serving(device, results):
    """Phase 17's library checks (the module docstring); keeps the bf16
    model, its tokenizer and the BEST file's path for the CLIs."""
    import concurrent.futures
    import copy
    import gc
    import os
    import shutil

    import numpy as np
    import torch

    from garbage_classification_rca_tpu_torch.cli.blip2_common import (
        build_blip2, normalize_clip)
    from garbage_classification_rca_tpu_torch.config import args_parser
    from garbage_classification_rca_tpu_torch.models.vlm import blip2
    from garbage_classification_rca_tpu_torch.models.vlm import opt as o
    from garbage_classification_rca_tpu_torch.ops.quant import (
        quantize_opt_weights)
    from garbage_classification_rca_tpu_torch.serving.engine import (
        GenerationServer)
    from garbage_classification_rca_tpu_torch.train.engine import save_best

    t0 = time.perf_counter()
    # the int8 witness's 370 M numpy draws, beside the first checks
    pool = concurrent.futures.ThreadPoolExecutor(1)
    witness = pool.submit(int8_witness_inputs)
    pool.shutdown(wait=False)
    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_serving")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    results["serving_work"] = work
    args = args_parser([])
    cfg, m16, tok = build_blip2(args, device, torch.bfloat16)
    blip2.init_lora_(m16.lora, SEED + 700, b_std=0.01)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        best = save_best(m16.lora, model_name="blip2_lora", epoch=0,
                         val_acc=0.0, args=args, fine_tuning=False,
                         layers=cfg.opt.layers)
    finally:
        os.chdir(cwd)
    opt16, lora16, scale = m16.opt, m16.lora, cfg.lora_scale
    n_query = cfg.qformer.n_query
    t_len = SERVE_PROMPT                   # phase 12's prompts: 100 tokens
    ids, mask = _serving_prompts(tok, SERVE_BATCH, SEED + 701, t_len)
    img = np.random.default_rng(SEED + 702).integers(
        0, 256, (SERVE_BATCH, 224, 224, 3), dtype=np.uint8)
    dev = lambda a: torch.from_numpy(a).to(device)
    ids_d, mask_d, img_d = dev(ids), dev(mask), dev(img)
    print(f"  BLIP-2 bf16 from --seed, adapters with B != 0 (the BEST file "
          f"for the CLIs), {SERVE_BATCH} prompts in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ok, out = True, {}
    with torch.inference_mode():
        # --- generate, bf16, batch 16: kernel path against plain path ---
        _zero_counters()
        e16, m_full = blip2.prompt_embeds(
            m16, normalize_clip(img_d, torch.bfloat16), ids_d, mask_d)
        ran_eva = _read_counters() == _want_launches(mha_tc=SERVE_K2["eva"])
        m_full = m_full.to(torch.int32)
        _gen(opt16, e16, m_full, lora16, scale, 2)              # warm-up
        _zero_counters()
        tk, vk, mk, sk = _gen(opt16, e16, m_full, lora16, scale, SERVE_NEW,
                              eos_id=-1)
        k2_gen = _read_counters()
        tp, vp, mp, sp = _gen(opt16, e16, m_full, lora16, scale, SERVE_NEW,
                              eos_id=-1, plain=True)
        lk, ck = _first_logits(opt16, e16, m_full, lora16, scale)
        with plain_versions():
            lpl, cp = _first_logits(opt16, e16, m_full, lora16, scale)
            # the one-ulp control: the plain path on the prompt
            # embeddings moved by N(0, 1) bf16 ulps
            g = torch.Generator(device=device).manual_seed(SEED + 709)
            e16u = (e16.float() * (1.0 + 2.0 ** -8 * torch.randn(
                e16.shape, generator=g, device=device))).to(torch.bfloat16)
            lu, cu = _first_logits(opt16, e16u, m_full, lora16, scale)
        valid = m_full.bool()
        cache_ok, cache_err, cache_ctl, layers_over_bar = True, 0.0, 0.0, 0
        for name in ("k", "v"):
            for i in range(cfg.opt.layers):
                got, want, ctl = (c[name][i][:, :-1][valid]
                                  for c in (ck, cp, cu))
                err, good = max_err_ok(got, want, torch.bfloat16, "block")
                control = float((ctl.float() - want.float()).abs().max())
                if i == 0:
                    good &= bool(torch.equal(got, want))
                elif not good:
                    layers_over_bar += 1
                    good = err <= control
                cache_ok &= good
                cache_err = max(cache_err, err)
                cache_ctl = max(cache_ctl, control)
        m32 = copy.deepcopy(m16).float()
        e32, _ = blip2.prompt_embeds(
            m32, normalize_clip(img_d, torch.float32), ids_d, mask_d)
        with plain_versions():
            truth, _ = _first_logits(m32.opt, e32, m_full, m32.lora, scale)
        aft = torch.as_tensor(_vlm_answer_tokens(tok), device=device).long()
        agree_ok, agr = fusion_agreement(lk[:, aft], lpl[:, aft],
                                         truth[:, aft])
        path_floor = float((lk - lpl).abs().max())   # the whole vocabulary
        agr["max_logit_diff_vocab"] = path_floor
        streams_ok, streams = near_tie_agree(tk, tp, mp, path_floor)
        k2_ok = k2_gen == _want_launches(mha_tc=SERVE_K2["opt"])
        good = (ran_eva and k2_ok and cache_ok and agree_ok and streams_ok
                and bool(vk.all()) and tuple(tk.shape) == (SERVE_BATCH,
                                                           SERVE_NEW))
        ok &= good
        out["generate_bf16"] = {
            "batch": SERVE_BATCH, "new_tokens": SERVE_NEW,
            "prompt": n_query + t_len, "seconds_kernel": sk,
            "seconds_plain": sp, "ms_per_token_step": sk * 1e3 / SERVE_NEW,
            "cache_max_err": cache_err, "cache_one_ulp_control": cache_ctl,
            "cache_layers_over_the_block_bar": layers_over_bar,
            "first_logits": agr, "streams": streams,
            "k2_launches": _shown(k2_gen), "ok": good}
        print(f"  generate bf16 {SERVE_BATCH} x ({n_query} + {t_len}) + "
              f"{SERVE_NEW}: kernel {sk:.2f} s, plain {sp:.2f} s; K2 "
              f"{_shown(k2_gen)} a generate ({'ok' if k2_ok else 'FAIL'}); "
              f"caches max|d| {cache_err:.3e}, {layers_over_bar} layer "
              f"tensors past the block bar, the one-ulp control "
              f"{cache_ctl:.3e} ({'ok' if cache_ok else 'FAIL'}; layer 0 "
              f"equal); first-step logits max|d| {path_floor:.3e} (the "
              f"answer tokens' {agr['max_logit_diff']:.3e}, agreement "
              f"{agr['agreement']} above {agr['noise_floor']:.3e}: "
              f"{'ok' if agree_ok else 'FAIL'}); "
              + _stream_line("kernel vs plain", streams)
              + f" {'ok' if good else 'FAIL'}", flush=True)

        # --- fp32, batch 4: identical streams, logits within 1e-4 ---
        b4 = slice(0, SERVE_FP32_BATCH)
        t32k, _, _, s32 = _gen(m32.opt, e32[b4], m_full[b4], m32.lora,
                               scale, SERVE_NEW, eos_id=-1)
        t32p, _, m32p, _ = _gen(m32.opt, e32[b4], m_full[b4], m32.lora,
                                scale, SERVE_NEW, eos_id=-1, plain=True)
        l32k, _ = _first_logits(m32.opt, e32[b4], m_full[b4], m32.lora,
                                scale)
        d32 = float((l32k - truth[b4]).abs().max())
        rel32 = d32 / float(truth[b4].abs().max())
        good = bool(torch.equal(t32k, t32p)) and rel32 <= 1e-4
        ok &= good
        out["generate_fp32"] = {"batch": SERVE_FP32_BATCH, "seconds": s32,
                                "first_logits_rel": rel32,
                                "identical": bool(torch.equal(t32k, t32p)),
                                "min_margin": float(m32p.min()), "ok": good}
        print(f"  generate fp32 {SERVE_FP32_BATCH} x ({n_query} + {t_len}) "
              f"+ {SERVE_NEW}: streams identical "
              f"{bool(torch.equal(t32k, t32p))} (smallest plain margin "
              f"{float(m32p.min()):.3e}), first-step logits {rel32:.2e} of "
              f"max|logit| {'ok' if good else 'FAIL'}", flush=True)
        del m32, e32          # the server's peak is read without them

        # --- the int8 witness (INT8_WITNESS): the JAX package's readings
        # at full width, 3 layers, held on the same model ---
        params_w, ids_w, mask_w = witness.result()
        w32 = int8_witness_readings(params_w, ids_w, mask_w, device,
                                    torch.float32)
        w16 = int8_witness_readings(params_w, ids_w, mask_w, device,
                                    torch.bfloat16, control=True)
        del params_w
        wj32, wj16 = (INT8_WITNESS_JAX[k] for k in ("float32", "bfloat16"))
        witness_ok = {
            "weights_fp32": abs(w32["weights"] - wj32) <= 1e-3 * wj32,
            "weights_bf16": abs(w16["weights"] - wj16)
            <= w16["weights_control"],
            "cache": max(w32["cache"], w16["cache"]) < INT8_CACHE_BAR}
        good = all(witness_ok.values())
        ok &= good
        out["int8_witness"] = {"float32": w32, "bfloat16": w16,
                               "jax": INT8_WITNESS_JAX, "held": witness_ok,
                               "ok": good}
        print(f"  int8 witness (OPT-2.7B widths, {SERVE_QUANT_LAYERS} "
              f"layers, {INT8_WITNESS['batch']} x {INT8_WITNESS['tokens']}; "
              f"the JAX package reads weights {wj32:.6e} fp32, "
              f"{wj16:.6e} bf16): weights fp32 {w32['weights']:.6e} "
              f"(within 1e-3 of JAX's: {witness_ok['weights_fp32']}), bf16 "
              f"{w16['weights']:.6e} (within the one-ulp control "
              f"{w16['weights_control']:.3e} of JAX's: "
              f"{witness_ok['weights_bf16']}); cache fp32 "
              f"{w32['cache']:.3e}, bf16 {w16['cache']:.3e} (bar "
              f"{INT8_CACHE_BAR}; the one-ulp control "
              f"{w16['cache_control']:.3e}) {'ok' if good else 'FAIL'}",
              flush=True)

        # --- int8 cache: kernel vs plain, and against the bf16 cache ---
        t8k, _, _, sec8 = _gen(opt16, e16, m_full, lora16, scale,
                               SERVE_NEW, eos_id=-1, cache_dtype="int8")
        t8p, _, m8p, _ = _gen(opt16, e16, m_full, lora16, scale, SERVE_NEW,
                              eos_id=-1, cache_dtype="int8", plain=True)
        s8_ok, s8 = near_tie_agree(t8k, t8p, m8p, path_floor)
        # one decode step's hidden, int8 cache against the bf16 cache: at
        # the depth of the JAX test (its bar, 0.02 of the largest |value|)
        # and at full depth beside the one-ulp control (recorded)
        step_in = (o.embed_tokens(opt16, tk[:, 0]).to(torch.bfloat16),
                   torch.full((SERVE_BATCH,), m_full.shape[1],
                              device=device),
                   m_full.sum(1) + cfg.opt.pos_offset,
                   torch.nn.functional.pad(m_full, (0, 1), value=1))

        def step_rel(model_opt, caches, ref):
            h = o.decode_step(model_opt, caches, *step_in, lora=lora16,
                              lora_scale=scale)[0].float()
            return h, (None if ref is None else float(
                (h - ref).abs().max() / ref.abs().max()))

        cut = _first_layers(opt16, SERVE_QUANT_LAYERS)
        h_cut, _ = step_rel(cut, _first_logits(cut, e16, m_full, lora16,
                                               scale)[1], None)
        _, rel8 = step_rel(cut, _first_logits(cut, e16, m_full, lora16,
                                              scale, "int8")[1], h_cut)
        _, cq = _first_logits(opt16, e16, m_full, lora16, scale, "int8")
        h_fp, _ = step_rel(opt16, ck, None)
        _, rel8_full = step_rel(opt16, cq, h_fp)
        _, ctl8 = step_rel(opt16, cu, h_fp)
        good = (s8_ok and rel8 < INT8_CACHE_BAR
                and cq["k"].dtype == torch.int8)
        ok &= good
        out["int8_cache"] = {"streams": s8, "decode_hidden_rel": rel8,
                             "layers": SERVE_QUANT_LAYERS,
                             "decode_hidden_rel_full_depth": rel8_full,
                             "one_ulp_control_full_depth": ctl8,
                             "seconds": sec8, "ok": good}
        print(f"  int8 cache: " + _stream_line("kernel vs plain", s8)
              + f"; one decode step's hidden from the bf16 cache's, "
              f"{SERVE_QUANT_LAYERS} layers: {rel8:.2e} of its largest "
              f"|value| (bar {INT8_CACHE_BAR}); all {cfg.opt.layers}: {rel8_full:.2e} "
              f"(recorded; the one-ulp control {ctl8:.2e}); generate "
              f"{sec8:.2f} s {'ok' if good else 'FAIL'}", flush=True)

        # --- int8 weights: kernel vs plain, and against bf16 ---
        q_opt = quantize_opt_weights(copy.deepcopy(opt16))
        tqk, _, _, sq = _gen(q_opt, e16, m_full, lora16, scale, SERVE_NEW,
                             eos_id=-1)
        tqp, _, mqp, _ = _gen(q_opt, e16, m_full, lora16, scale, SERVE_NEW,
                              eos_id=-1, plain=True)
        sq_ok, sqa = near_tie_agree(tqk, tqp, mqp, path_floor)
        # the int8 weights themselves, at full width: every dequantized
        # weight within half a step of its bf16 weight, and the int8
        # Linear (x @ w, then the scale, then the bias, in bf16) against
        # the fp32 product of the dequantized weights, to the blocks' bf16
        # bar, on layer 0's q projection of the path's input
        w_ok = True
        for name in ("q", "k", "v", "out", "fc1", "fc2"):
            lq8, l16 = (getattr(m.layers[0], name) for m in (q_opt, opt16))
            deq = lq8.w.float() * lq8.w_scale.t()
            w_ok &= bool(((deq - l16.w.float()).abs()
                          <= lq8.w_scale.t() * (0.5 + 1e-5)).all())
        lin = q_opt.layers[0].q
        x = opt16.layers[0].ln1(e16)
        ref = x.float() @ (lin.w.float() * lin.w_scale.t()).t() \
            + lin.b.float()
        lin_err, lin_ok = max_err_ok(lin(x), ref, torch.bfloat16, "block")
        # the first-step logits against bf16's: at the JAX test's depth held
        # to what the JAX package reads at that depth and width (the
        # witness's bf16 reading, up to its one-ulp control); at full depth
        # recorded beside the one-ulp control
        rel_of = lambda a, b: float((a - b).abs().max() / b.abs().max())
        relq = rel_of(_first_logits(_first_layers(q_opt, SERVE_QUANT_LAYERS),
                                    e16, m_full, lora16, scale)[0],
                      _first_logits(cut, e16, m_full, lora16, scale)[0])
        relq_full = rel_of(_first_logits(q_opt, e16, m_full, lora16,
                                         scale)[0], lk)
        ctlq = rel_of(lu, lpl)
        relq_bar = wj16 + w16["weights_control"]
        good = (sq_ok and w_ok and lin_ok and relq <= relq_bar
                and q_opt.layers[0].q.w.dtype == torch.int8)
        ok &= good
        out["int8_weights"] = {"streams": sqa, "weights_in_half_a_step": w_ok,
                               "linear_max_err": lin_err,
                               "first_logits_rel": relq,
                               "first_logits_rel_bar": relq_bar,
                               "layers": SERVE_QUANT_LAYERS,
                               "first_logits_rel_full_depth": relq_full,
                               "one_ulp_control_full_depth": ctlq,
                               "seconds": sq,
                               "ms_per_token_step": sq * 1e3 / SERVE_NEW,
                               "bf16_ms_per_token_step":
                                   sk * 1e3 / SERVE_NEW, "ok": good}
        print(f"  int8 weights: " + _stream_line("kernel vs plain", sqa)
              + f"; layer 0's weights within half a step {w_ok}, its q "
              f"projection against the fp32 dequantized product max|d| "
              f"{lin_err:.3e} ({'ok' if lin_ok else 'FAIL'}); first-step "
              f"logits from bf16's: {SERVE_QUANT_LAYERS} layers {relq:.2e} "
              f"of max|logit| (bar {relq_bar:.3e}: the witness's bf16 "
              f"reading and its control), all {cfg.opt.layers} "
              f"{relq_full:.2e} (recorded; the one-ulp control "
              f"{ctlq:.2e}); generate "
              f"{sq:.2f} s against bf16's {sk:.2f} s "
              f"{'ok' if good else 'FAIL'}", flush=True)
        del q_opt, cq, ck, cp, cu

        # --- the server: 24 requests against their own B = 1 generate ---
        n_img = SERVE_REQUESTS // 2
        t_img = SERVE_PROMPT - n_query
        ids_t, mask_t = _serving_prompts(tok, SERVE_REQUESTS - n_img,
                                         SEED + 703, SERVE_PROMPT)
        ids_i, mask_i = _serving_prompts(tok, n_img, SEED + 704, t_img)
        img_i = dev(np.random.default_rng(SEED + 705).integers(
            0, 256, (n_img, 224, 224, 3), dtype=np.uint8))
        reqs = []
        for g0 in range(0, n_img, SERVE_SLOTS):   # a vision batch of 8
            e, m = blip2.prompt_embeds(
                m16, normalize_clip(img_i[g0:g0 + SERVE_SLOTS],
                                    torch.bfloat16),
                dev(ids_i[g0:g0 + SERVE_SLOTS]),
                dev(mask_i[g0:g0 + SERVE_SLOTS]))
            reqs += [(e[j], m[j]) for j in range(e.shape[0])]
        txt = o.embed_tokens(opt16, dev(ids_t)).to(torch.bfloat16)
        reqs += [(txt[j], dev(mask_t[j])) for j in range(len(txt))]
        order = np.random.default_rng(SEED + 706).permutation(len(reqs))
        reqs = [reqs[int(i)] for i in order]
        budgets = [1 + (31 * i) // (len(reqs) - 1) for i in range(len(reqs))]
        budgets = [budgets[int(i)] for i in np.random.default_rng(
            SEED + 707).permutation(len(reqs))]
        # each request alone at B = 1, without an EOS: its whole stream,
        # margins, and for the first refill's rows the first two steps'
        # logits
        alone, first = [], []
        for j, (e, m) in enumerate(reqs):
            lg = [] if j < SERVE_SLOTS else None
            toks, marg = _alone(opt16, lora16, scale, e, m, SERVE_PROMPT,
                                SERVE_NEW, SERVE_NEW, -1, logits=lg)
            alone.append((toks.cpu(), marg.cpu()))
            if lg is not None:
                first.append(lg)
        # the EOS: a token inside a few streams, so that some requests
        # retire on it and others on their budget
        counts = {}
        for (toks, _), n in zip(alone, budgets):
            for t in set(toks[1:n].tolist()):
                counts[t] = counts.get(t, 0) + 1
        eos = min(counts, key=lambda t: (abs(counts[t] - 4), t))
        # the floor: the first refill's rows batched against B = 1, over
        # the first two steps (the prefill's logits, the first decode
        # step's)
        pad = lambda e, m: (torch.nn.functional.pad(
            e, (0, 0, 0, SERVE_PROMPT - e.shape[0])),
            torch.nn.functional.pad(m.to(torch.int32),
                                    (0, SERVE_PROMPT - m.shape[0])))
        rows = [pad(e, m) for e, m in reqs[:SERVE_SLOTS]]
        lb = []
        tb, _, _, _ = _gen(opt16, torch.stack([r[0] for r in rows]),
                           torch.stack([r[1] for r in rows]), lora16, scale,
                           SERVE_NEW, logits=lb, eos_id=-1)
        batch_floor = 0.0
        for j in range(SERVE_SLOTS):
            steps = 2 if int(tb[j, 0]) == int(alone[j][0][0]) else 1
            for s_ in range(steps):
                batch_floor = max(batch_floor, float(
                    (lb[s_][j] - first[j][s_][0]).abs().max()))
        srv = GenerationServer(opt16, slots=SERVE_SLOTS,
                               max_prompt=SERVE_PROMPT, max_new=SERVE_NEW,
                               eos_id=eos, lora=lora16, lora_scale=scale,
                               steps_per_sync=SERVE_SYNC)
        prefills = {"n": 0}
        real_prefill = o.prefill

        def counted(*a, **kw):
            prefills["n"] += 1
            return real_prefill(*a, **kw)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        resident = torch.cuda.memory_allocated(device)   # BLIP-2 bf16, data
        _zero_counters()
        o.prefill = counted
        try:
            t1 = time.perf_counter()
            for (e, m), n in zip(reqs, budgets):
                srv.submit(e, m, max_new=n)
            srv.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        finally:
            o.prefill = real_prefill
        serving = _read_counters()
        peak = torch.cuda.max_memory_allocated(device)
        served = srv.requests
        n_tok = sum(len(r.tokens) for r in served.values())
        ttft = np.asarray([r.t_first - r.t_submit for r in served.values()])
        lat = np.asarray([r.t_done - r.t_submit for r in served.values()])
        prof = _profile_decode(srv, SERVE_SYNC)
        same = cut = under = 0
        bad = []
        for uid, ((toks, marg), n) in enumerate(zip(alone, budgets)):
            hit = (toks == eos).nonzero()
            keep = min(n, int(hit[0]) + 1 if len(hit) else SERVE_NEW)
            a_ok, a = _agree_one(served[uid].tokens, toks[:keep],
                                 marg[:keep], batch_floor)
            same += a["identical"]
            cut += a["cut_at_a_near_tie"]
            under += a["steps_under_floor"]
            if not a_ok:
                bad.append(uid)
        retired_on_eos = sum(r.done for r in served.values())
        k2_per_prefill = serving["mha_tc"] / max(prefills["n"], 1)
        good = (not bad and all(r.finished for r in served.values())
                and prefills["n"] > 1 and k2_per_prefill == SERVE_K2["opt"]
                and serving == _want_launches(mha_tc=serving["mha_tc"]))
        ok &= good
        out["server"] = {
            "requests": len(reqs), "slots": SERVE_SLOTS,
            "max_prompt": SERVE_PROMPT, "steps_per_sync": SERVE_SYNC,
            "max_new": SERVE_NEW, "budgets": budgets, "eos_id": eos,
            "generated_tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall,
            "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
            "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3,
            "latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "latency_p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "decode": prof, "peak_gib": peak / 2**30,
            "resident_before_gib": resident / 2**30,
            "peak_above_resident_gib": (peak - resident) / 2**30,
            "prefills": prefills["n"], "k2_per_prefill": k2_per_prefill,
            "retired_on_eos": retired_on_eos, "identical_streams": same,
            "cut_at_a_near_tie": cut, "steps_under_floor": under,
            "batch_floor": batch_floor, "disagreeing": bad,
            "launches": _shown(serving), "ok": good}
        results["serving_launches"] = serving
        print(f"  server {SERVE_SLOTS} slots, {len(reqs)} requests (half "
              f"image; budgets 1 to {SERVE_NEW}; EOS id {eos}, "
              f"{retired_on_eos} retired on it): {n_tok} tokens in "
              f"{wall:.2f} s = {n_tok / wall:.1f} tokens/s; time to first "
              f"token p50 {np.percentile(ttft, 50) * 1e3:.1f} / p95 "
              f"{np.percentile(ttft, 95) * 1e3:.1f} ms; latency p50 "
              f"{np.percentile(lat, 50) * 1e3:.1f} / p95 "
              f"{np.percentile(lat, 95) * 1e3:.1f} ms; decode "
              f"{prof['wall_ms_per_step']:.2f} ms a step (device "
              f"{prof['device_ms_per_step']:.2f} ms, idle "
              f"{prof['idle_share']:.3f}, {prof['device_ops_per_step']:.0f} "
              f"device operations a step); peak {peak / 2**30:.2f} GiB, "
              f"{(peak - resident) / 2**30:.2f} GiB above the "
              f"{resident / 2**30:.2f} GiB resident before the server; "
              f"{prefills['n']} prefills, K2 {k2_per_prefill:g} a prefill; "
              f"{same} of {len(reqs)} streams identical to their B = 1 "
              f"run, {cut} cut at a near tie (floor {batch_floor:.3e}, "
              f"{under} steps under it), disagreeing {bad} "
              f"{'ok' if good else 'FAIL'}", flush=True)
        del srv

        # --- speculative decoding, fp32, batch 4 ---
        dcfg = o.OPTConfig(**OPT_125M)
        with torch.device("meta"):
            draft = o.OPTDecoder(dcfg)
        draft = draft.to_empty(device=device).requires_grad_(False)
        g = torch.Generator(device=device).manual_seed(SEED + 708)
        for mod in draft.modules():
            if isinstance(mod, type(draft.final_ln)):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
            else:
                for t in mod.parameters(recurse=False):
                    t.normal_(0.0, 0.02, generator=g)
        ids4, mask4 = dev(ids_t[:SERVE_FP32_BATCH]), dev(
            mask_t[:SERVE_FP32_BATCH])
        opt32 = copy.deepcopy(opt16).float()
        lora32 = copy.deepcopy(lora16).float()
        te = o.embed_tokens(opt32, ids4)
        de = o.embed_tokens(draft, ids4)
        _zero_counters()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ts, vs = o.speculative_generate(opt32, draft, te, de, mask4,
                                        SERVE_NEW, draft_k=SPEC_DRAFT_K,
                                        lora=lora32, lora_scale=scale)
        torch.cuda.synchronize()
        s_spec = time.perf_counter() - t2
        spec_k2 = _read_counters()
        tg, vg, _, s_g = _gen(opt32, te, mask4, lora32, scale,
                              SERVE_NEW)
        good = (bool(torch.equal(ts, tg)) and bool(torch.equal(vs, vg))
                and spec_k2 == _want_launches(mha=cfg.opt.layers
                                              + dcfg.layers))
        ok &= good
        out["speculative"] = {
            "batch": SERVE_FP32_BATCH, "draft_k": SPEC_DRAFT_K,
            "draft": OPT_125M, "seconds": s_spec, "generate_seconds": s_g,
            "equal": bool(torch.equal(ts, tg)),
            "launches": _shown(spec_k2), "ok": good}
        print(f"  speculative fp32 {SERVE_FP32_BATCH} x {SERVE_NEW}, draft "
              f"OPT-125m widths, k {SPEC_DRAFT_K}: equal to greedy generate "
              f"{bool(torch.equal(ts, tg))} ({s_spec:.2f} s against "
              f"{s_g:.2f} s); launches {_shown(spec_k2)} "
              f"{'ok' if good else 'FAIL'}", flush=True)
        del opt32, lora32, draft
    gc.collect()
    torch.cuda.empty_cache()
    results["serving"] = out
    results["serving_model"] = (cfg, m16, tok, best)
    results["serving_seconds"] = time.perf_counter() - t0
    print(f"  phase 17's library checks in {results['serving_seconds']:.1f} s",
          flush=True)
    return ok


def check_serving_clis(device, results):
    """``cli.blip2_test --max_new_tokens=4`` three ways and ``cli.serve``
    on 16 JSONL lines, on the BEST file of ``check_serving`` (the towers
    from ``--seed``: the in-process model's weights); the work directory
    is removed after."""
    import io
    import os
    import shutil

    import numpy as np
    import torch

    from garbage_classification_rca_tpu_torch.cli import blip2_test, serve
    from garbage_classification_rca_tpu_torch.config import args_parser
    from garbage_classification_rca_tpu_torch.models.vlm import opt as o

    cfg, m16, tok, best = results.pop("serving_model")
    work = results.pop("serving_work")
    cwd = os.getcwd()
    ok, out, t0 = True, {}, time.perf_counter()
    try:
        _write_jpeg_tree(os.path.join(work, "garbage"), 0, 16, SEED + 710,
                         size=320)
        os.chdir(work)
        for tag, flags in (("greedy", []),
                           ("sampled", ["--gen_temperature=0.7",
                                        "--gen_top_k=50", "--gen_top_p=0.9",
                                        "--gen_seed=3"]),
                           ("int8", ["--int8_weights",
                                     "--kv_cache_dtype=int8"])):
            argv = [f"--model_path={best}", "--dataset_folder_name="
                    "garbage_Val", "--max_new_tokens=4"] + flags
            _zero_counters()
            t1 = time.perf_counter()
            main_ok, report = drive_eval_main(blip2_test, argv)
            torch.cuda.synchronize()
            launches = _read_counters()
            good = main_ok and launches == _want_launches(
                mha_tc=SERVE_K2["eva"] + SERVE_K2["opt"])
            ok &= good
            out[f"blip2_test_{tag}"] = {
                "seconds": time.perf_counter() - t1, "report": report,
                "launches": _shown(launches), "ok": good}
            print(f"  cli.blip2_test --max_new_tokens=4 {tag} on 16 JPEGs in "
                  f"{time.perf_counter() - t1:.1f} s: launches "
                  f"{_shown(launches)} {'ok' if good else 'FAIL'}",
                  flush=True)
        # cli.serve: 16 lines, a malformed one and a bad field among them
        imgs = sorted(os.path.join(r, f) for r, _, fs in os.walk(
            "garbage_Val") for f in fs)[:6]
        reqs = [{"id": f"t{i}", "text": f"Question: which bin takes a "
                 f"{VLM_ITEMS[i]}? Answer:", "max_new": 2 + i}
                for i in range(8)]
        reqs += [{"id": f"i{i}", "text": "Question: which bin? Answer:",
                  "image": p, "max_new": 8 - i} for i, p in enumerate(imgs)]
        lines = [json.dumps(r) for r in reqs]
        lines[4:4] = ["{not json", json.dumps({"id": "bad", "text": 7})]
        argv = [f"--model_path={best}", "--max_new_tokens=8"]
        stdout = io.StringIO()
        _zero_counters()
        t1 = time.perf_counter()
        rc = serve.main(argv, stdin=io.StringIO("\n".join(lines) + "\n"),
                        stdout=stdout)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        launches = _read_counters()
        answers = [json.loads(l) for l in stdout.getvalue().splitlines()]
        by_id = {}
        for a in answers:
            by_id.setdefault(a["id"], []).append(a)
        once = all(len(v) == 1 for v in by_id.values()) and set(by_id) == {
            r["id"] for r in reqs} | {"bad"}
        errors = "error" in by_id.get("bad", [{}])[0]
        # the in-process reference: the CLI's own embedders on m16, then
        # each request's B = 1 generate as the server pads it
        sargs = args_parser(argv)
        embed = serve._build_embedders(cfg, m16, sargs, tok, torch.bfloat16)
        from garbage_classification_rca_tpu_torch.data.images import (
            blip_preprocess_image)

        pixs = [blip_preprocess_image(r["image"]).astype(np.uint8)
                if r.get("image") else None for r in reqs]
        same = cut = 0
        bad = []
        with torch.inference_mode():
            for r, (e, m) in zip(reqs, embed(reqs, pixs)):
                want, marg = _alone(m16.opt, m16.lora, cfg.lora_scale, e,
                                    torch.from_numpy(m).to(device),
                                    sargs.max_prompt, sargs.max_new_tokens,
                                    r["max_new"], 2)
                if len(want) and int(want[-1]) == 2:  # the CLI strips it
                    want, marg = want[:-1], marg[:-1]
                a_ok, a = _agree_one(by_id[r["id"]][0].get("tokens", []),
                                     want, marg,
                                     results["serving"]["server"][
                                         "batch_floor"])
                same += a["identical"]
                cut += a["cut_at_a_near_tie"]
                if not a_ok:
                    bad.append(r["id"])
        k2 = launches["mha_tc"]
        # 39 a vision batch (one a round that took image requests), 32 a
        # prefill: both ran
        split = any((k2 - SERVE_K2["eva"] * a) % SERVE_K2["opt"] == 0
                    and k2 - SERVE_K2["eva"] * a >= SERVE_K2["opt"]
                    for a in range(1, len(imgs) + 1))
        good = (rc == 0 and once and errors and not bad and split
                and launches == _want_launches(mha_tc=k2))
        ok &= good
        out["serve"] = {"seconds": secs, "lines": len(lines),
                        "answers": len(answers), "identical": same,
                        "cut_at_a_near_tie": cut, "disagreeing": bad,
                        "launches": _shown(launches), "ok": good}
        print(f"  cli.serve on {len(lines)} lines in {secs:.1f} s: "
              f"{len(answers)} answer lines, one a request {once}, the bad "
              f"field's error line {errors}; {same} of {len(reqs)} greedy "
              f"answers identical to in-process generate, {cut} cut at a "
              f"near tie; launches {_shown(launches)} "
              f"{'ok' if good else 'FAIL'}", flush=True)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    results["serving_clis"] = out
    print(f"  phase 17 in {results['serving_seconds'] + out['seconds']:.1f} s",
          flush=True)
    return ok


# ---------------------------------------------------------------------------
# phase 18: the Llama paraphraser behind GC_RCA_LLM_PATH (cli.main_text
# --use_synonyms); no hand-written kernel, no counter
# ---------------------------------------------------------------------------

# meta-llama/Llama-3.1-8B-Instruct's first special tokens, in its order
# (ids 128000-128010 there; here after the fixture's vocabulary); the 245
# reserved ones after them are left out
LLAMA3_SPECIALS = (
    "<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
    "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
    "<|reserved_special_token_2|>", "<|start_header_id|>",
    "<|end_header_id|>", "<|eom_id|>", "<|eot_id|>", "<|python_tag|>")
# Llama-3's Split pre-tokenizer pattern (its tokenizer.json)
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                r"|\s+(?!\S)|\s+")
# A Llama-3-style chat template written for this script and its tests
# (headers, eot, a system header, loop controls, raise_exception); it is
# not Meta's template text.
LLAMA3_STYLE_TEMPLATE = (
    "{#- A Llama-3-style chat template written for this repository's "
    "checks; not Meta's template text. -#}\n"
    "{{- bos_token }}\n"
    "{%- if messages[0]['role'] == 'system' %}\n"
    "    {%- set system = messages[0]['content'] | trim %}\n"
    "    {%- set messages = messages[1:] %}\n"
    "{%- else %}\n"
    "    {%- set system = 'Answer briefly.' %}\n"
    "{%- endif %}\n"
    "{{- '<|start_header_id|>system<|end_header_id|>\\n\\n' }}\n"
    "{{- 'Knowledge cut-off: 2023-12\\n\\n' + system + '<|eot_id|>' }}\n"
    "{%- for message in messages %}\n"
    "    {%- if message['role'] not in ['user', 'assistant'] %}\n"
    "        {{- raise_exception('only user and assistant turns follow "
    "the system one') }}\n"
    "    {%- endif %}\n"
    "    {%- if not message['content'] %}{% continue %}{% endif %}\n"
    "    {{- '<|start_header_id|>' + message['role'] + "
    "'<|end_header_id|>\\n\\n' + message['content'] | trim + "
    "'<|eot_id|>' }}\n"
    "{%- endfor %}\n"
    "{%- if add_generation_prompt %}\n"
    "    {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}\n"
    "{%- endif %}\n")
PARA_SEED = SEED + 800
PARA_NEW = 6                       # the paraphraser's new tokens
# the sentences of the full-width run's batch (make_hf_llm_fn's 8)
PARA_SENTENCES = (
    "a crumpled plastic water bottle", "an empty glass jar of jam",
    "old newspapers tied with string", "a banana peel in the sink",
    "a dented soda can", "a used AA battery", "a greasy pizza box",
    "a broken green wine bottle")
LLAMA3_FIRST_SPECIAL = 128000      # <|begin_of_text|>'s id in Llama-3
PARA_CHECK_LAYERS = 2              # the card-vs-CPU and the CLI's model
# the sampling make_hf_llm_fn runs (GenerationConfig's default top-k)
PARA_SAMPLING = {"temperature": 0.4, "top_k": 50, "top_p": 0.9}


def llama3_tokenizer_spec(vocab_dir):
    """A ``tokenizer.json`` of Llama-3's form on the byte-level BPE
    vocabulary of `vocab_dir` (``vocab.json`` + ``merges.txt``): its
    Split + ByteLevel pre-tokenizer, ``ignore_merges`` and the
    ``LLAMA3_SPECIALS`` after the vocabulary."""
    import os

    with open(os.path.join(vocab_dir, "vocab.json"), encoding="utf-8") as f:
        vocab = json.load(f)
    with open(os.path.join(vocab_dir, "merges.txt"), encoding="utf-8") as f:
        merges = [line.rstrip("\n") for n, line in enumerate(f)
                  if line.strip() and not (n == 0 and line.startswith("#"))]
    added = [{"id": len(vocab) + i, "content": t, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for i, t in enumerate(LLAMA3_SPECIALS)]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": True, "use_regex": False}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
             "behavior": "Isolated", "invert": False}, byte_level]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges}}


def write_safetensors(path, tensors):
    """`tensors` ({name: CPU tensor}) as one safetensors file."""
    import struct

    import torch

    names = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16"}
    header, blobs, at = {"__metadata__": {"format": "pt"}}, [], 0
    for name, t in tensors.items():
        b = t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + b.nbytes]}
        blobs.append(b)
        at += b.nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for b in blobs:
            f.write(b.tobytes())


def write_llama_dir(path, model, tokenizer_spec, *, dtype, shards=2,
                    template=LLAMA3_STYLE_TEMPLATE):
    """A transformers Llama directory of `model` (a port
    ``LlamaForCausalLM``) in `dtype`: ``config.json``,
    ``generation_config.json`` (Llama-3.1-8B-Instruct's sampling: no
    top-k), the weights in `shards` safetensors files with their index,
    ``tokenizer.json`` and a ``tokenizer_config.json`` with the chat
    template, bos ``<|begin_of_text|>`` and eos ``<|eot_id|>``."""
    import os

    cfg = model.cfg
    ids = {t["content"]: t["id"] for t in tokenizer_spec["added_tokens"]}
    bos, eot = ids["<|begin_of_text|>"], ids["<|eot_id|>"]
    os.makedirs(path, exist_ok=True)
    config = {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "hidden_size": cfg.hidden, "intermediate_size": cfg.ffn,
        "num_hidden_layers": cfg.layers, "num_attention_heads": cfg.heads,
        "num_key_value_heads": cfg.kv_heads, "vocab_size": cfg.vocab,
        "rms_norm_eps": cfg.rms_eps, "rope_theta": cfg.rope_theta,
        "rope_scaling": cfg.rope_scaling,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "max_position_embeddings": cfg.max_positions, "hidden_act": "silu",
        "attention_bias": False, "mlp_bias": False, "bos_token_id": bos,
        "eos_token_id": [ids["<|end_of_text|>"], ids["<|eom_id|>"], eot],
        "torch_dtype": str(dtype).replace("torch.", "")}
    gen = {"bos_token_id": bos, "eos_token_id": config["eos_token_id"],
           "do_sample": True, "temperature": 0.6, "top_p": 0.9}
    tok_cfg = {"bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
               "chat_template": template,
               "clean_up_tokenization_spaces": True,
               "model_input_names": ["input_ids", "attention_mask"],
               "tokenizer_class": "PreTrainedTokenizerFast"}
    for name, obj in (("config.json", config),
                      ("generation_config.json", gen),
                      ("tokenizer.json", tokenizer_spec),
                      ("tokenizer_config.json", tok_cfg)):
        with open(os.path.join(path, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)
    sd = {k: v.detach().to("cpu", dtype) for k, v in
          model.hf_state_dict().items()}
    names = list(sd)
    cut = [names[i * len(names) // shards:(i + 1) * len(names) // shards]
           for i in range(shards)]
    weight_map = {}
    for i, part in enumerate(cut):
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        write_safetensors(os.path.join(path, fname), {k: sd[k] for k in part})
        weight_map.update({k: fname for k in part})
    total = sum(v.numel() * v.element_size() for v in sd.values())
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    return total


def paraphraser_prompts(device):
    """The reference's prompts (``synonymize.chats``) of
    ``PARA_SENTENCES``, rendered with ``LLAMA3_STYLE_TEMPLATE`` and
    tokenized, left padded with <|eot_id|>, by the Llama-3-style tokenizer
    of the BPE fixture (``llama3_tokenizer_spec``); its specials moved to
    their Llama-3 ids (``LLAMA3_FIRST_SPECIAL`` on), the rest of its ids
    being ids of Llama-3's vocabulary too: (ids, mask)."""
    import os

    import numpy as np
    import torch

    from garbage_classification_rca_tpu_torch.data import synonymize
    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        HFTokenizer)

    spec = llama3_tokenizer_spec(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
        "vocab", "bpe"))
    tok = HFTokenizer(spec, {"bos_token": "<|begin_of_text|>",
                             "eos_token": "<|eot_id|>"},
                      LLAMA3_STYLE_TEMPLATE)
    ids, mask = tok.batch(synonymize.chats(tok, PARA_SENTENCES)[0])
    base = len(spec["model"]["vocab"])
    ids = np.where(ids >= base, ids - base + LLAMA3_FIRST_SPECIAL, ids)
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(mask).to(device))


def _para_warp():
    from garbage_classification_rca_tpu_torch.ops.sampling import (
        warp_logits_hf)

    return functools.partial(warp_logits_hf, **PARA_SAMPLING)


def _para_full_width(device, out):
    """Llama-3.1-8B-Instruct's geometry, fp32, weights from ``PARA_SEED``
    on the card: ``generate`` of the ``paraphraser_prompts``, ``PARA_NEW`` new
    tokens at ``PARA_SAMPLING``; prefill ms, decode ms a step (the draw
    included), the device's idle share over a whole ``generate``, peak
    memory; two runs from one seed draw the same tokens."""
    import torch

    from garbage_classification_rca_tpu_torch.models.text import llama

    cfg = llama.LlamaConfig()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = llama.LlamaForCausalLM.empty(cfg, device).init_(PARA_SEED)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    eot = LLAMA3_FIRST_SPECIAL + LLAMA3_SPECIALS.index("<|eot_id|>")
    ids, mask = paraphraser_prompts(device)
    warp = _para_warp()

    def gen(seed):
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        return llama.generate(model, ids, mask, max_new_tokens=PARA_NEW,
                              warp=warp, eos_id=eot, pad_id=eot, generator=g)

    with torch.inference_mode():
        first = gen(PARA_SEED).cpu()               # warm
        again = gen(PARA_SEED).cpu()
        g = torch.Generator(device=device)
        g.manual_seed(PARA_SEED)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = model.prefill(ids, mask, PARA_NEW)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for _ in range(PARA_NEW - 1):
            nxt = torch.multinomial(torch.softmax(warp(logits), -1), 1,
                                    generator=g).squeeze(1)
            logits = model.decode_step(nxt, cache)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        kinds, _, n_ops, wall = _trace(lambda r: gen(PARA_SEED).cpu(), 1,
                                       _kind)
    busy = sum(kinds.values())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = bool(torch.isfinite(logits).all())
    same = torch.equal(first, again)
    good = (n_params == cfg.params() and finite and same
            and ids.shape[1] < first.shape[1] <= ids.shape[1] + PARA_NEW
            and all(p.is_cuda for p in model.parameters()))
    row = {"params": n_params, "built_s": built,
           "prompt_tokens": mask.sum(1).tolist(),
           "prefill_ms": (t2 - t1) * 1e3,
           "decode_ms_per_step": (t3 - t2) * 1e3 / (PARA_NEW - 1),
           "generate_wall_ms": wall, "device_ms": busy,
           "idle_share": 1.0 - busy / wall, "device_ops": n_ops,
           "by_kind_ms": kinds, "peak_mem_gib": peak,
           "same_tokens_from_one_seed": same, "ok": good}
    print(f"  Llama-3.1-8B-Instruct geometry, fp32, {n_params / 1e9:.3f} B "
          f"parameters drawn on the card in {built:.1f} s; "
          f"{ids.shape[0]} rendered prompts of {min(row['prompt_tokens'])}"
          f"-{max(row['prompt_tokens'])} tokens, {PARA_NEW} new at "
          f"{PARA_SAMPLING}: prefill {row['prefill_ms']:.2f} ms, decode "
          f"{row['decode_ms_per_step']:.2f} ms a step; a generate: wall "
          f"{wall:.2f} ms, device {busy:.2f} ms, idle share "
          f"{row['idle_share']:.3f}, {n_ops} device operations; peak "
          f"{peak:.2f} GiB; one seed twice: same tokens {same} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    del model, cache, logits
    torch.cuda.empty_cache()
    out["full_width"] = row
    return good


def _para_card_vs_cpu(device, out):
    """``PARA_CHECK_LAYERS`` layers at full width, fp32, TF32 off: the
    card's logits of each of ``PARA_NEW`` sampling steps (prefill, then the
    cached decode) against the CPU's teacher-forced forward over the same
    tokens. Bar: max |d| / max |logit| <= max(1e-5, the one-ulp control:
    the card's own teacher-forced logits moved by a one-ulp move of the
    embedding table)."""
    import dataclasses as dc

    import torch

    from garbage_classification_rca_tpu_torch.models.text import llama

    cfg = dc.replace(llama.LlamaConfig(), layers=PARA_CHECK_LAYERS)
    model = llama.LlamaForCausalLM.empty(cfg, device).init_(PARA_SEED + 2)
    eot = LLAMA3_FIRST_SPECIAL + LLAMA3_SPECIALS.index("<|eot_id|>")
    ids, mask = paraphraser_prompts(device)
    raw, warp = [], _para_warp()

    def keep(logits):
        raw.append(logits)
        return warp(logits)

    g = torch.Generator(device=device)
    g.manual_seed(PARA_SEED)
    n = ids.shape[1]
    with torch.inference_mode():
        full = llama.generate(model, ids, mask, max_new_tokens=PARA_NEW,
                              warp=keep, eos_id=eot, pad_id=eot, generator=g)
        steps = len(raw)
        card = torch.stack(raw, 1).cpu()                 # [B, steps, V]
        fmask = torch.cat([mask, torch.ones_like(full[:, n:])], 1)
        tf = slice(n - 1, n - 1 + steps)
        card_tf = model(full[:, :n - 1 + steps], fmask[:, :n - 1 + steps],
                        keep=tf).cpu()
        cpu_model = llama.LlamaForCausalLM.empty(cfg, "cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        w = model.model.embed_tokens.w
        w.copy_(torch.nextafter(w, torch.full_like(w, float("inf"))))
        moved = model(full[:, :n - 1 + steps], fmask[:, :n - 1 + steps],
                      keep=tf).cpu()
        del model, w
        torch.cuda.empty_cache()
        cpu = cpu_model(full[:, :n - 1 + steps].cpu(),
                        fmask[:, :n - 1 + steps].cpu(), keep=tf)
    scale = float(cpu.abs().max())
    err = float((card - cpu).abs().max()) / scale
    cache_vs_forward = float((card - card_tf).abs().max()) / scale
    control = float((moved - card_tf).abs().max()) / scale
    bar = max(1e-5, control)
    good = err <= bar and bool(torch.isfinite(card).all())
    row = {"layers": PARA_CHECK_LAYERS, "steps": steps,
           "max_rel_err": err, "cache_vs_forward_rel": cache_vs_forward,
           "one_ulp_control": control, "bar": bar, "ok": good}
    print(f"  {PARA_CHECK_LAYERS} layers at full width, fp32: the card's "
          f"logits over {steps} sampling steps (prefill + cached decode) "
          f"against the CPU's teacher-forced forward: max |d| / max |logit| "
          f"{err:.3e} (the card's cache against its own forward "
          f"{cache_vs_forward:.3e}; one-ulp control {control:.3e}; bar "
          f"{bar:.3e}) {'ok' if good else 'FAIL'}", flush=True)
    del cpu_model
    out["card_vs_cpu"] = row
    return good


def _para_cli(device, out):
    """``cli.main_text --text_model=distilbert --use_synonyms
    --prob_aug_text=1`` for one step with ``GC_RCA_LLM_PATH`` at a
    directory written here (full width at ``PARA_CHECK_LAYERS`` layers in
    bf16, two safetensors shards and their index, the fixture's BPE
    vocabulary with Llama-3's specials and Split pattern,
    ``LLAMA3_STYLE_TEMPLATE``); the paraphraser's parameters must be on
    the card and every sentence must go through it."""
    import dataclasses as dc
    import os
    import shutil

    import torch

    from garbage_classification_rca_tpu_torch.cli import main_text
    from garbage_classification_rca_tpu_torch.data import synonymize
    from garbage_classification_rca_tpu_torch.models.text import llama

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_paraphraser")
    shutil.rmtree(work, ignore_errors=True)
    spec = llama3_tokenizer_spec(os.path.join(here, "tests", "fixtures",
                                              "vocab", "bpe"))
    vocab = len(spec["model"]["vocab"]) + len(spec["added_tokens"])
    cfg = dc.replace(llama.LlamaConfig(), layers=PARA_CHECK_LAYERS,
                     vocab=vocab)
    model = llama.LlamaForCausalLM.empty(cfg, device).init_(PARA_SEED + 3)
    t0 = time.perf_counter()
    size = write_llama_dir(os.path.join(work, "llama"), model, spec,
                           dtype=torch.bfloat16, shards=2)
    written = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    _write_jpeg_tree(os.path.join(work, "txt"), 16, 8, PARA_SEED + 4,
                     size=32)
    seen = {"on_card": None, "calls": 0, "answers": []}
    load, make = synonymize.load_llm, main_text.make_hf_llm_fn

    def spy_load(path, dev):
        m, tok, gen = load(path, dev)
        seen["on_card"] = all(p.is_cuda for p in m.parameters())
        seen["dtype"] = str(next(m.parameters()).dtype)
        return m, tok, gen

    def spy_make(*a, **kw):
        fn = make(*a, **kw)

        def counted(s):
            seen["calls"] += 1
            answer = fn(s)
            seen["answers"].append(answer)
            return answer

        return counted

    cwd = os.getcwd()
    os.makedirs(os.path.join(work, "cli"))
    os.chdir(os.path.join(work, "cli"))
    os.environ["GC_RCA_LLM_PATH"] = os.path.join(work, "llama")
    synonymize.load_llm, main_text.make_hf_llm_fn = spy_load, spy_make
    try:
        t1 = time.perf_counter()
        best = main_text.main([
            f"--dataset_folder_name={work}/txt", "--text_model=distilbert",
            "--use_synonyms", "--prob_aug_text=1", "--epochs=1",
            "--ft_epochs=0", "--batch_size=16", "--acc_steps=1",
            "--seq_len=64", "--data_workers=1", "--name=paraphraser",
            f"--vocab_dir={here}/tests/fixtures/vocab/wordpiece"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
    finally:
        synonymize.load_llm, main_text.make_hf_llm_fn = load, make
        os.environ.pop("GC_RCA_LLM_PATH", None)
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    good = (seen["on_card"] is True and seen["calls"] == 16
            and all(isinstance(a, str) for a in seen["answers"])
            and best is not None)
    row = {"vocab": vocab, "layers": PARA_CHECK_LAYERS,
           "dir_bytes": size, "write_s": written, "cli_s": secs,
           "on_card": seen["on_card"], "dtype": seen.get("dtype"),
           "paraphrased": seen["calls"], "answers": seen["answers"][:4],
           "ok": good}
    print(f"  cli.main_text --use_synonyms --prob_aug_text=1, one step, "
          f"GC_RCA_LLM_PATH at a {size / 2 ** 30:.2f} GiB bf16 directory "
          f"(2 shards + index, written in {written:.1f} s; vocabulary "
          f"{vocab}): {secs:.1f} s; paraphraser on the card "
          f"{seen['on_card']} ({seen.get('dtype')}), {seen['calls']} "
          f"sentences paraphrased, e.g. {seen['answers'][:2]} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    out["cli"] = row
    return good


def check_paraphraser(device, results):
    """Phase 18 (``_para_full_width``, ``_para_card_vs_cpu``,
    ``_para_cli``): ``regex`` and ``jinja2`` import on this machine, the
    paraphraser runs at full width on the card, agrees with the CPU, and
    drives ``cli.main_text --use_synonyms``."""
    import jinja2
    import regex

    out = {"regex": regex.__version__, "jinja2": jinja2.__version__}
    print(f"  regex {regex.__version__}, jinja2 {jinja2.__version__}",
          flush=True)
    t0 = time.perf_counter()
    ok = _para_full_width(device, out)
    ok &= _para_card_vs_cpu(device, out)
    ok &= _para_cli(device, out)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 18 in {out['seconds']:.1f} s", flush=True)
    results["paraphraser"] = out
    return ok


# ---------------------------------------------------------------------------
# phase 19: data parallelism (two ranks sharing the card over gloo; NCCL at
# world size 1 under --fsdp)
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_BATCH, DP_ACC = 16, 2          # per rank: global 2 x 16, acc 2
DP_TRAIN_KERNELS = ("rca_fused", "rca_fused_bwd", "mha_fwd_lse",
                    "mha_flash_bwd_tc32")       # K1, K3, K4a, K4b
DP_FP32_BARS = {"loss": 1e-5, "grad": 1e-4}     # PERF.md §2, fp32 train
DP_BF16_LOSS = 1e-3        # relative, the bf16 train bar (PERF.md §2)
DP_VANISHING = 1e-6        # a gradient below this share of the largest one
DP_CONTROL_FACTOR = 1.5    # no further than 1.5x the one-ulp control moves
FSDP_RTOL, FSDP_ATOL = 3e-4, 1e-6               # the JAX tests/test_fsdp.py


def run_dp_step(model, spec, mesh, timed=False, control=False):
    """One train step of `model` (in place) on this rank's rows of the
    global stack ``spec["stack"]`` ([acc, B, ...] numpy), through the
    port's ``make_train_step`` on `mesh` (a ``parallel.mesh.DataMesh``; one
    rank: the one-device step): SGD, class weights, label smoothing,
    augmentation at ``spec["prob_aug"]``, the model's own dropout and
    stochastic depth, images in ``spec["image_dtype"]`` (with
    ``spec["exact_convs"]`` TF32 off and cuDNN off: PyTorch's own
    convolutions compute each sample alike at any batch size, where cuDNN
    picks other algorithms for 16 samples than for 32). Returns the loss,
    per-microbatch losses, norms, the launch counters of the step and, on
    rank 0, the gradients and the updated state (CPU). `control`: the same
    step again from the same weights with every normalized image value
    moved by one fp32 ulp, up or down at random ("control_grads" /
    "control_state": how far rounding-level noise in the activations
    moves each tensor). `timed`: three more steps on cuDNN in ``spec["timed_dtype"]``: a
    warm-up, one timed (global samples/s, peak memory), one under the
    profiler (the all-reduce's share of its wall)."""
    import torch

    from garbage_classification_rca_tpu_torch.data.augment import (
        augment_batch)
    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)
    from garbage_classification_rca_tpu_torch.nn.core import Key
    from garbage_classification_rca_tpu_torch.train.loop import (
        make_train_step)
    from garbage_classification_rca_tpu_torch.train.optim import (
        make_optimizer)

    dev = mesh.device
    dtype = [getattr(torch, spec["image_dtype"])]
    nudge = [None]
    full = spec["stack"]
    rows = mesh.local_rows(full["label"].shape[1])
    stack = {k: torch.from_numpy(v[:, rows]).to(dev) for k, v in full.items()}
    cw = torch.tensor(spec["class_weights"], device=dev)

    def batch_to_inputs(mb, key):
        x = mb["image"]
        if spec["prob_aug"] > 0:
            x = augment_batch(x, spec["prob_aug"], key.generator(dev))
        x = normalize_on_device(x, dtype=dtype[0])
        if nudge[0] is not None:
            up = torch.rand(x.shape, generator=nudge[0], device=dev) < 0.5
            x = torch.nextafter(x, torch.where(up, x + 1, x - 1))
        return (mb["input_ids"], mb["attention_mask"], x)

    opt = make_optimizer("sgd", model.named_parameters(), spec["lr"],
                         spec["reg"])
    step = make_train_step(model, opt, batch_to_inputs=batch_to_inputs,
                           class_weights=cw,
                           label_smoothing=spec["label_smoothing"],
                           mesh=mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled)
    if spec.get("exact_convs"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.enabled = False
    init = ({k: v.detach().clone() for k, v in model.state_dict().items()}
            if control else None)
    _zero_counters()
    t0 = time.perf_counter()
    loss, losses, norms = step(stack, Key(spec["key"]))
    sync()
    out = {"loss": float(loss), "step1_s": time.perf_counter() - t0,
           "losses": losses.tolist(), "grad_norm": float(norms["grad_norm"]),
           "param_norm": float(norms["param_norm"]),
           "launches": _read_counters(), "rank": mesh.rank,
           "backend": mesh.backend or "none (one process)"}
    if mesh.is_primary:
        out["grads"] = {n: p.grad.detach().cpu()
                        for n, p in model.named_parameters()}
        out["state"] = {k: v.detach().cpu()
                        for k, v in model.state_dict().items()}
    if control:
        model.load_state_dict(init)
        del init
        nudge[0] = torch.Generator(device=dev).manual_seed(spec["key"])
        out["control_loss"] = float(step(stack, Key(spec["key"]))[0])
        nudge[0] = None
        out["control_grads"] = {n: p.grad.detach().cpu()
                                for n, p in model.named_parameters()}
        out["control_state"] = {k: v.detach().cpu()
                                for k, v in model.state_dict().items()}
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled = flags
    if timed:
        dtype[0] = getattr(torch, spec.get("timed_dtype",
                                           spec["image_dtype"]))
        float(step(stack, Key(spec["key"] + 3))[0])
        sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        float(step(stack, Key(spec["key"] + 1))[0])
        sync()
        wall = time.perf_counter() - t0
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            float(step(stack, Key(spec["key"] + 2))[0])
            sync()
            prof_wall = time.perf_counter() - t0
        reduce_us = sum(e.cpu_time_total for e in prof.key_averages()
                        if "all_reduce" in e.key or "allreduce" in e.key)
        out.update(step_s=wall, samples_per_s=full["label"].size / wall,
                   peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                             if dev.type == "cuda" else None),
                   allreduce_share=reduce_us * 1e-6 / prof_wall,
                   profiled_step_s=prof_wall)
    return out


def dp_step_worker(spec_paths: str) -> int:
    """A rank of ``run_dp_step`` (``python3 chip_smoke.py
    --dp_step=<spec>[,<spec>...]``, spawned by
    ``parallel.multihost.launch``): the process group from the launcher's
    environment; for each spec in turn, its pickled model on this rank's
    device, one step, ``rank<r>.pt`` written into the spec's ``out``
    directory."""
    import os

    import torch

    from garbage_classification_rca_tpu_torch.parallel.multihost import (
        initialize_from_env)

    for path in spec_paths.split(","):
        spec = torch.load(path, weights_only=False)
        torch.set_num_threads(spec.get("threads", 2))
        mesh = initialize_from_env(spec["device"])
        model = spec.pop("model").to(mesh.device)
        out = run_dp_step(model, spec, mesh, timed=spec.get("timed", False))
        torch.save(out, os.path.join(spec["out"], f"rank{mesh.rank}.pt"))
        del model, out
    return 0


def run_test_both(argv, logits=None):
    """``cli.test_both.main(argv)`` with TF32 off (an fp32 eval is then
    fp32 throughout); returns its ``evaluate``'s (acc, labels, preds).
    `logits`: a list that gets each batch's logits."""
    import torch

    from garbage_classification_rca_tpu_torch.cli import test_both

    kept = []
    evaluate, load = test_both.evaluate, test_both.load_model
    test_both.evaluate = lambda args: kept.append(evaluate(args)) or kept[-1]

    def load_hooked(*a, **k):
        model = load(*a, **k)
        model.register_forward_hook(
            lambda mod, inp, out: logits.append(out.float().cpu()))
        return model

    if logits is not None:
        test_both.load_model = load_hooked
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        test_both.main(argv)
    finally:
        test_both.evaluate, test_both.load_model = evaluate, load
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = flags
    return kept[0][:3]


def center_head(path, argv, work):
    """Shift the final head's bias in the BEST file at `path` by the mean
    of its logits over `argv`'s eval set (a one-rank ``cli.test_both`` in
    `work`): the centred logits sum to zero over the set, so its
    predictions cannot all be one class (a random model's are, its
    features being alike for every sample)."""
    import torch

    logits = []
    _in_dir(work, run_test_both, argv, logits)
    payload = torch.load(path, weights_only=True)
    b = payload["state_dict"]["final_with_everything.b"]
    b -= torch.cat(logits).mean(0).to(b.dtype)
    torch.save(payload, path)


def dp_eval_worker(argv) -> int:
    """A rank of ``cli.test_both`` (``python3 chip_smoke.py --dp_eval
    <flags>``, spawned by ``parallel.multihost.launch``): writes its
    (acc, labels, preds) to ``eval_rank<r>.npz``."""
    import os

    import numpy as np

    acc, labels, preds = run_test_both(argv)
    np.savez(f"eval_rank{os.environ.get('RANK', '0')}.npz", acc=acc,
             labels=labels, preds=preds)
    return 0


def dp_grad_errors(got, want, zero=()):
    """{name: max |got - want| over the tensor's largest |want|}; a
    gradient that is zero in exact arithmetic (`zero`,
    ``exact_zero_grads``) is sized against its sibling's, and none against
    less than ``DP_VANISHING`` of the largest |want| of all (a vanishing
    gradient, e.g. a cross attention's query at a near-uniform softmax, is
    rounding noise on both sides)."""
    floor = DP_VANISHING * max(float(w.float().abs().max())
                               for w in want.values())
    out = {}
    for n, w in want.items():
        ref = want[_sibling(n)] if n in zero else w
        scale = max(float(ref.float().abs().max()), floor)
        d = float((got[n].float() - w.float()).abs().max())
        out[n] = d / scale if scale else d
    return out


def dp_card_errors(got, want, state=False):
    """{name: max |got - want| over the tensor's scale} for the card's
    check: a bias is sized against the larger of its own and its sibling
    weight's largest |value| (a bias gradient sums a weight gradient's
    terms without their activations, and may cancel), a BN running mean
    against the largest running standard deviation of its layer (the
    spread its batch means are taken over), everything else against its
    own largest |value|, and none against less than DP_VANISHING of the
    largest of all."""
    import math

    mx = {n: float(w.float().abs().max()) for n, w in want.items()}
    floor = DP_VANISHING * max(mx.values())
    out = {}
    for n, w in want.items():
        scale = mx[n]
        if state and n.endswith(".mean") and n[:-4] + "var" in want:
            scale = math.sqrt(mx[n[:-4] + "var"])
        elif not state and n.endswith((".b", ".bias")) \
                and _sibling(n) in want:
            scale = max(scale, mx[_sibling(n)])
        d = float((got[n].float() - w.float()).abs().max())
        out[n] = d / max(scale, floor)
    return out


def dp_compare(got, want, loss_bar=DP_FP32_BARS["loss"]):
    """(ok, line, numbers): a data-parallel step's rank-0 result against
    the one-device step's on the card: the loss within `loss_bar` of its
    size (at least 1); each gradient, updated weight and BN running
    statistic within 1e-4 of its scale (``dp_card_errors``), or no
    further than DP_CONTROL_FACTOR times the largest move of the
    one-device step's one-ulp control. cuBLAS and cuDNN run other kernels
    for 16 samples than for 32, and the squeeze-excitation gradients
    (sums over the feature map that cancel), BN batch means near zero and,
    in bf16, the depthwise and stem convolutions' weight gradients turn
    their rounding into a large share of their own size; the control
    measures that amplification (``tools/dp_bf16_check.py``)."""
    g = dp_card_errors(got["grads"], want["grads"])
    st = dp_card_errors(got["state"], want["state"], state=True)
    cg = dp_card_errors(want["control_grads"], want["grads"])
    cs = dp_card_errors(want["control_state"], want["state"], state=True)
    loss_d = abs(got["loss"] - want["loss"])
    strict = dp_grad_errors(got["grads"], want["grads"])
    nums = {"grad_worst": max(g.values()), "state_worst": max(st.values()),
            "control_grad_worst": max(cg.values()),
            "control_state_worst": max(cs.values()),
            "control_loss_diff": abs(want["control_loss"] - want["loss"]),
            "loss_diff": loss_d,
            "grad_worst_own_scale": max(strict.values())}
    g_bar = max(DP_FP32_BARS["grad"],
                DP_CONTROL_FACTOR * nums["control_grad_worst"])
    s_bar = max(DP_FP32_BARS["grad"],
                DP_CONTROL_FACTOR * nums["control_state_worst"])
    nums.update(grad_bar=g_bar, state_bar=s_bar)
    ok = (loss_d <= loss_bar * max(1.0, abs(want["loss"]))
          and nums["grad_worst"] <= g_bar and nums["state_worst"] <= s_bar)
    top = sorted(g, key=g.get)[-3:]
    ws = max(st, key=st.get)
    line = (f"loss {got['loss']:.6f} vs {want['loss']:.6f} (|d| "
            f"{loss_d:.2e}); worst gradients {[(n, float(f'{g[n]:.3g}')) for n in top]}"
            f" (bar {g_bar:.2e}; on each tensor's own scale "
            f"{nums['grad_worst_own_scale']:.2e}); worst state {ws} "
            f"{st[ws]:.2e} (bar {s_bar:.2e}); the one-ulp control "
            f"{nums['control_grad_worst']:.2e} / "
            f"{nums['control_state_worst']:.2e}, loss "
            f"{nums['control_loss_diff']:.2e}")
    return ok, line, nums


def dp_launch(cmd, nproc, work, *, backend, share_device, timeout=300):
    """``parallel.multihost.launch`` of `cmd` with the checkout on the
    path, in `work`: (ok, [(code, output)]); a failed rank's last lines
    are printed."""
    import os

    from garbage_classification_rca_tpu_torch.parallel.multihost import (
        launch)

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    res = launch(cmd, nproc, backend=backend, share_device=share_device,
                 timeout=timeout, env=env, cwd=work)
    for r, (code, log) in enumerate(res):
        if code != 0:
            print(f"  rank {r} of {cmd[:2]} exited {code}:\n"
                  + "\n".join(log.splitlines()[-25:]), flush=True)
    return all(code == 0 for code, _ in res), res


def dp_step_spec(work):
    """(model on the CPU, ``run_dp_step`` spec) of phase 19(a): the
    MM_RCA.sh model from the seed and a global stack of DP_ACC x DP_RANKS
    x DP_BATCH synthetic rows, a padded tail in the last rank's rows; fp32
    images with TF32 and cuDNN off, timed in bf16."""
    import numpy as np
    import torch

    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        WordPieceTokenizer)
    from garbage_classification_rca_tpu_torch.models.fusion import multimodal

    cfg = multimodal.FusionConfig(strategy="MM_RCA", reverse=True,
                                  drop_ratio=0.6,
                                  image_or_text_dropout_chance=0.0)
    model = multimodal.build_fusion_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(SEED + 19))
    tok = WordPieceTokenizer.from_vocab_file(
        "tests/fixtures/vocab/wordpiece/vocab.txt")
    data = SyntheticBatcher(DP_ACC * DP_RANKS * DP_BATCH, DP_RANKS * DP_BATCH,
                            (TRAIN_IMAGE, TRAIN_IMAGE), tok, 64, SEED + 20)
    stack = {k: np.stack([b[k] for b in data.batches])
             for k in data.batches[0]}
    stack["valid"][-1, -3:] = 0      # a padded tail in rank 1's rows
    return model, {"model": model, "stack": stack, "device": "cuda",
                   "out": work, "image_dtype": "float32",
                   "exact_convs": True, "timed_dtype": "bfloat16",
                   "class_weights": [0.8, 1.1, 0.9, 1.3], "prob_aug": 1.0,
                   "lr": 0.0016, "reg": 0.03, "label_smoothing": 0.0,
                   "key": SEED + 19, "timed": True}


def _dp_train_step(device, results, work, smi_line):
    """(a): the MM_RCA.sh step at full width over two ranks sharing the
    card (gloo), held to the one-rank step of the same global batch in
    fp32 images with TF32 and cuDNN off (``run_dp_step``), then timed in
    the recipe's bf16 images on cuDNN; and the bf16 step on cuDNN, held
    to the one-rank bf16 step within its own one-ulp control (at random
    weights a bf16 ulp on the images moves the worst gradients as far as
    the split over two ranks does: ``tools/dp_bf16_check.py``), the loss
    within the bf16 train bar. Both ranks' steps run in one launch."""
    import os

    import torch

    from garbage_classification_rca_tpu_torch.parallel.mesh import DataMesh
    from garbage_classification_rca_tpu_torch.train.engine import (
        CHECKPOINT_FORMAT)

    t0 = time.perf_counter()
    model, spec = dp_step_spec(work)
    path = os.path.join(work, "dp_spec.pt")
    torch.save(spec, path)
    spec16 = dict(spec, image_dtype="bfloat16", exact_convs=False,
                  timed=False, out=os.path.join(work, "bf16"))
    os.makedirs(spec16["out"])
    path16 = os.path.join(work, "dp_spec_bf16.pt")
    torch.save(spec16, path16)
    # the seeded weights as a BEST file: (b)'s eval model, its head centred
    # there so that its predictions vary (a 1 + 1 epoch model's are one
    # class, and so are the seeded model's before the centring)
    torch.save({"format": CHECKPOINT_FORMAT, "meta": {"layers": 6},
                "state_dict": model.state_dict()},
               os.path.join(work, "seeded_best"))
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    ref = run_dp_step(model.to(device), spec, DataMesh(0, 1, device),
                      timed=True, control=True)
    model.load_state_dict(init)
    ref16 = run_dp_step(model, spec16, DataMesh(0, 1, device), control=True)
    del model, init
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok, _ = dp_launch([os.path.abspath(__file__),
                       f"--dp_step={path},{path16}"],
                      DP_RANKS, work, backend="gloo", share_device=True)
    two_s = time.perf_counter() - t0
    if not ok:
        return False
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(DP_RANKS)]
    held, line, nums = dp_compare(ranks[0], ref)
    held16, line16, nums16 = dp_compare(
        torch.load(os.path.join(spec16["out"], "rank0.pt"),
                   weights_only=False), ref16, loss_bar=DP_BF16_LOSS)
    del ref16
    per_rank = [{k: r["launches"][k] for k in DP_TRAIN_KERNELS}
                for r in ranks]
    launched = all(all(n > 0 for n in pr.values()) for pr in per_rank)
    print(f"  two ranks on one card ({ranks[0]['backend']}; {smi_line}), "
          f"fp32 images, TF32 and cuDNN off: {line}", flush=True)
    print(f"  bf16 images on cuDNN (held to the bf16 one-ulp control, the "
          f"loss within {DP_BF16_LOSS:g} relative): {line16} "
          f"{'ok' if held16 else 'FAIL'}", flush=True)
    print(f"  launches per rank {per_rank} (one rank: "
          f"{ {k: ref['launches'][k] for k in DP_TRAIN_KERNELS} }); bf16 "
          f"images: two ranks sharing the card: "
          f"{ranks[0]['samples_per_s']:.1f} train "
          f"samples/s ({ranks[0]['step_s']:.2f} s a step), one rank "
          f"{ref['samples_per_s']:.1f} ({ref['step_s']:.2f} s); peak memory "
          f"per rank {[round(r['peak_gib'], 2) for r in ranks]} GiB (one "
          f"rank {ref['peak_gib']:.2f}); all-reduce share of a profiled "
          f"step {[round(r['allreduce_share'], 4) for r in ranks]}; set-up "
          f"{setup_s:.1f} s, one rank {one_s:.1f} s (first step "
          f"{ref['step1_s']:.1f} s), two ranks {two_s:.1f} s (first step "
          f"{ranks[0]['step1_s']:.1f} s)", flush=True)
    results["dp_step"] = {
        "backend": ranks[0]["backend"], "held": line, **nums,
        "bf16": {"held": line16, "ok": held16, **nums16},
        "launches_per_rank": per_rank,
        "samples_per_s_two_ranks_one_card": ranks[0]["samples_per_s"],
        "step_s_two_ranks_one_card": ranks[0]["step_s"],
        "samples_per_s_one_rank": ref["samples_per_s"],
        "step_s_one_rank": ref["step_s"],
        "peak_gib_per_rank": [r["peak_gib"] for r in ranks],
        "peak_gib_one_rank": ref["peak_gib"],
        "allreduce_share": [r["allreduce_share"] for r in ranks],
        "global_batch": f"{DP_RANKS} x {DP_BATCH} x acc {DP_ACC}",
        "held_in": "float32 images, TF32 and cuDNN off",
        "timed_in": "bfloat16 images, cuDNN", "seconds": {
            "setup": setup_s, "one_rank": one_s, "two_ranks": two_s},
        "card": smi_line}
    results["dp_launches"] = ranks[0]["launches"]
    return held and held16 and launched


def _jsonl_rows(d):
    import glob
    import json as _json

    return [_json.loads(line) for f in glob.glob(f"{d}/runs/*.jsonl")
            for line in open(f)]


def _report_csv(root):
    import glob

    csvs = glob.glob(f"{root}/test_set_reports/*/*_report_test_set_acc_*.csv")
    if len(csvs) != 1:
        return None, None
    with open(csvs[0], "rb") as f:
        return csvs[0].rsplit("/", 1)[-1], f.read()


def _in_dir(d, fn, *args):
    """`fn(*args)` with `d` as the working directory."""
    import os

    cwd = os.getcwd()
    os.chdir(d)
    try:
        return fn(*args)
    finally:
        os.chdir(cwd)


def _dp_clis_and_fsdp(device, results, work):
    """(b) ``cli.main_both`` over two ranks (1 + 1 epochs) on a synthetic
    480x480 tree (its BEST file, in a one-rank ``cli.test_both``, gives its
    best val_acc within a sample), then ``cli.test_both`` in fp32 over two
    ranks on (a)'s seeded weights with the head centred on the eval set
    (``center_head``: the predictions vary): every rank's accuracy, labels
    and predictions and the report CSV equal a one-rank
    ``cli.test_both``'s (this process, meanwhile); (c), beside (b)'s
    training, one ``--fsdp`` step of
    ``cli.main_text`` (DistilBERT, all trainable, SGD: AdamW's sign-like
    first step would turn rounding on a vanishing gradient into a whole
    learning rate) in a process group of one rank on NCCL, held to the run
    without a group (this process, meanwhile): the JSONL row and the BEST
    file's weights within the JAX FSDP test's rtol 3e-4, atol 1e-6."""
    import concurrent.futures as cf
    import glob
    import os

    import torch

    from garbage_classification_rca_tpu_torch.cli import main_text

    here = os.path.dirname(os.path.abspath(__file__))
    vocab = os.path.join(here, "tests", "fixtures", "vocab", "wordpiece")
    pkg = "garbage_classification_rca_tpu_torch.cli."
    _write_jpeg_tree(os.path.join(work, "garbage"), 16, 8, SEED + 21)
    text_argv = ["--dataset_folder_name=../garbage", "--text_model=distilbert",
                 "--epochs=1", "--ft_epochs=0", "--no-tl", "--batch_size=16",
                 "--acc_steps=1", "--opt=sgd", "--lr=0.01", "--reg=0.01",
                 "--balance_weights", "--seq_len=64", "--eval_batch_size=8",
                 f"--vocab_dir={vocab}"]
    for d in ("fsdp", "plain", "two", "one", "trained", "center"):
        os.makedirs(os.path.join(work, d))
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(2) as ex:
        fb = ex.submit(dp_launch, [
            "-m", pkg + "main_both", "--dataset_folder_name=garbage",
            "--late_fusion=MM_RCA", "--reverse", "--epochs=1",
            "--ft_epochs=1", "--batch_size=16", "--batch_size_FT=16",
            "--acc_steps=1", "--acc_steps_FT=1", "--prob_aug=1.0",
            "--opt=sgd", "--lr=0.0016", "--reg=0.03", "--fraction_lr=3",
            "--balance_weights", "--image_text_dropout=0.0",
            f"--mesh_shape=data:{DP_RANKS}", "--eval_batch_size=4",
            f"--vocab_dir={vocab}"], DP_RANKS, work, backend="gloo",
            share_device=True)
        fc = ex.submit(dp_launch, ["-m", pkg + "main_text", "--fsdp"]
                       + text_argv, 1, os.path.join(work, "fsdp"),
                       backend=None, share_device=False)
        _in_dir(os.path.join(work, "plain"), main_text.main, text_argv)
        ok_b, _ = fb.result()
        ok_c, res_c = fc.result()
    train_s = time.perf_counter() - t0
    if not (ok_b and ok_c):
        return False
    group = [ln for ln in res_c[0][1].splitlines()
             if ln.startswith("process group:")]
    runs = {}
    for what in ("fsdp", "plain"):
        d = os.path.join(work, what)
        best = glob.glob(f"{d}/model_weights/distilbert/BEST_*")
        runs[what] = (_jsonl_rows(d), torch.load(best[0], weights_only=True)[
            "state_dict"] if len(best) == 1 else None)
    (rf, sf), (rp, sp) = runs["fsdp"], runs["plain"]
    ok_c = (len(rf) == len(rp) == 1 and sf is not None and sp is not None
            and bool(group) and "backend nccl" in group[0])
    worst = float("inf")
    if ok_c:
        for k in ("avg_loss", "grad_norm_last", "param_global_norm"):
            ok_c &= abs(rf[0][k] - rp[0][k]) <= FSDP_ATOL + FSDP_RTOL * abs(
                rp[0][k])
        worst = max(float((sf[k].float() - v.float()).abs().max())
                    / (FSDP_ATOL + FSDP_RTOL * float(v.float().abs().max()))
                    for k, v in sp.items())
        ok_c &= worst <= 1.0
    print(f"  (c) cli.main_text --fsdp: {group[0] if group else 'no group'};"
          f" loss {rf[0]['avg_loss'] if rf else None} vs "
          f"{rp[0]['avg_loss'] if rp else None} without a group; BEST weights"
          f" at {worst:.3f} of the FSDP tolerance (rtol {FSDP_RTOL}, atol "
          f"{FSDP_ATOL})", flush=True)
    rows = _jsonl_rows(work)
    bests = glob.glob(f"{work}/model_weights/MM_RCA_distilbert/BEST_*")
    seeded = os.path.join(work, "seeded_best")
    argv = ["--late_fusion=MM_RCA", "--reverse", "--text_model=distilbert",
            f"--model_path={seeded}", "--dataset_folder_name=../garbage_Val",
            f"--vocab_dir={vocab}", "--eval_batch_size=4",
            "--compute_dtype=float32"]
    t0 = time.perf_counter()
    center_head(seeded, argv, os.path.join(work, "center"))
    with cf.ThreadPoolExecutor(1) as ex:
        ft = ex.submit(dp_launch, [os.path.abspath(__file__), "--dp_eval"]
                       + argv + [f"--mesh_shape=data:{DP_RANKS}"],
                       DP_RANKS, os.path.join(work, "two"), backend="gloo",
                       share_device=True)
        one = _in_dir(os.path.join(work, "one"), run_test_both, argv)
        ok_t, _ = ft.result()
    # the BEST file of (b)'s two-rank training evaluates to its best
    # val_acc (the val folder is the test folder here) within one sample:
    # test_both folds BN, the val eval does not, and a near tie may flip
    trained = None
    if bests:
        best = max(bests, key=os.path.getmtime)
        trained = _in_dir(os.path.join(work, "trained"), run_test_both,
                          argv[:3] + [f"--model_path={best}"] + argv[4:-1])
    test_s = time.perf_counter() - t0
    name2, csv2 = _report_csv(os.path.join(work, "two"))
    name1, csv1 = _report_csv(os.path.join(work, "one"))
    same = csv1 is not None and csv1 == csv2 and name1 == name2
    import numpy as np

    two = [np.load(os.path.join(work, "two", f"eval_rank{r}.npz"))
           for r in range(DP_RANKS)] if ok_t else []
    same_preds = bool(two) and all(
        float(t["acc"]) == one[0] and np.array_equal(t["labels"], one[1])
        and np.array_equal(t["preds"], one[2]) for t in two)
    n_classes = len(np.unique(one[2]))
    best_acc = max((r["val_acc"] for r in rows), default=None)
    trained_ok = (trained is not None and best_acc is not None
                  and abs(trained[0] - best_acc) <= 100.0 / len(one[1])
                  + 1e-6)
    ok_b = (ok_t and same and same_preds and n_classes > 1 and trained_ok
            and len(rows) == 2
            and {r["phase"] for r in rows} == {"train", "fine_tune"}
            and all(r["avg_loss"] == r["avg_loss"] for r in rows))
    print(f"  (b) cli.main_both over {DP_RANKS} ranks, 1 + 1 epochs (beside "
          f"(c)) in {train_s:.1f} s: "
          f"{[(r['phase'], round(r['avg_loss'], 4), r['val_acc']) for r in rows]}"
          f"; its BEST file in a one-rank cli.test_both: "
          f"{trained[0] if trained else None} % (best val_acc {best_acc}); "
          f"cli.test_both (fp32) over {DP_RANKS} ranks on (a)'s seeded "
          f"weights, head centred, beside the one-rank run in {test_s:.1f} "
          f"s: {n_classes} classes predicted {one[2].tolist()}, "
          f"acc / labels / preds "
          f"{'identical on every rank' if same_preds else 'DIFFER'}, "
          f"report {name2} "
          f"{'byte-identical to' if same else 'DIFFERS from'} the one-rank "
          f"run's {name1}", flush=True)
    results["dp_clis"] = {"train_s": train_s, "test_s": test_s, "rows": rows,
                          "csv_identical": same, "preds_identical": same_preds,
                          "classes_predicted": n_classes,
                          "trained_best_acc": trained[0] if trained else None,
                          "report": name1}
    results["dp_fsdp"] = {"backend": group[0] if group else None,
                          "rows_fsdp": rf, "rows_plain": rp,
                          "worst_of_tolerance": worst}
    return ok_b and ok_c


def check_data_parallel(device, results, smi_line):
    """Phase 19: (a) ``_dp_train_step``, then (b) and (c)
    (``_dp_clis_and_fsdp``), in a work directory of the checkout, deleted
    after."""
    import os
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_dp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        ok = _dp_train_step(device, results, work, smi_line)
        ok &= _dp_clis_and_fsdp(device, results, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return ok


# ---------------------------------------------------------------------------
# phase 20: tensor parallelism (model:2) and sequence parallelism (seq:2)
# ---------------------------------------------------------------------------

TP_RANKS = 2
TP_BATCH, TP_NEW, TP_ACC = 16, 32, 2     # (a) / (b) batch, (b)'s new tokens
TP_HEADS = 16                            # OPT-2.7B's 32 heads over model:2
TP_LAUNCHES = {"eval": {"mha_tc": 71}, "generate": {"mha_tc": 32},
               "train": {"mha_tc": 39 * TP_ACC, "mha_fwd_lse_tc": 32 * TP_ACC,
                         "mha_flash_bwd_tc": 32 * TP_ACC}}
TP_LOGIT_BAR = 0.05                      # phase 12's bf16 |d logit| bar
TP_SERVE_NEW = 8
SP_SEQ_LEN, SP_TEXTS = 512, 24           # cli.test_text: 16 + 8 texts
PHASE20_BUDGET_S = 150.0


def tp_path_work(mesh, spec, control=False):
    """The BLIP-2 main path on `mesh` (``parallel.mesh.DataMesh``; one
    rank: the unsharded model): blip2-opt-2.7b in bf16 from the seed, the
    adapters fp32 with B != 0, the OPT tower sliced over the model axis
    (``place_blip2``), then (a) the 1-token eval's next-token logits of
    ``spec["eval"]`` (TP_BATCH rows), (b) ``opt.generate`` of TP_NEW
    greedy tokens over its prompt embeddings, (c) one LoRA step
    (``make_lora_train_step``, acc TP_ACC over ``spec["window"]``), with
    `control` the same step again VLM_CONTROL_DRAWS times with the
    projection's output moved by N(0, 1) bf16 ulps (``opt_attention``),
    (d) each timed again, the peak memory of building the whole model and
    of the work after the slicing.
    The counters are zeroed before each of (a)-(c) and read after."""
    import torch

    from garbage_classification_rca_tpu_torch.cli import blip2_train
    from garbage_classification_rca_tpu_torch.cli.blip2_common import (
        build_blip2, normalize_clip, place_blip2)
    from garbage_classification_rca_tpu_torch.config import args_parser
    from garbage_classification_rca_tpu_torch.models.vlm import blip2

    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, model, _ = build_blip2(args_parser([f"--seed={spec['seed']}"]),
                                dev, torch.bfloat16, train=True)
    blip2.init_lora_(model.lora, spec["seed"] + 1, b_std=0.01)
    place_blip2(model, mesh)
    torch.cuda.synchronize()
    # the whole model is built before the tower is sliced: the peak of the
    # work below is read from here on
    out = {"rank": mesh.rank, "build_s": time.perf_counter() - t0,
           "build_peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ev = {k: torch.from_numpy(v).to(dev) for k, v in spec["eval"].items()}
    x = normalize_clip(ev["image"], torch.bfloat16)

    def logits():
        return blip2.next_token_logits(model, x, ev["input_ids"],
                                       ev["attention_mask"])

    with torch.inference_mode():
        _zero_counters()
        out["logits"] = logits().float().cpu()
        out["eval_launches"] = _read_counters()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits()
        torch.cuda.synchronize()
        out["eval_s"] = time.perf_counter() - t1
        e, m = blip2.prompt_embeds(model, x, ev["input_ids"],
                                   ev["attention_mask"])
        m = m.to(torch.int32)
        _zero_counters()
        toks, _, marg, out["gen_s"] = _gen(model.opt, e, m, model.lora,
                                           cfg.lora_scale, TP_NEW, eos_id=-1)
        out["gen_launches"] = _read_counters()
        out["tokens"], out["margins"] = toks.cpu(), marg.cpu()
        del e, m
    win = {k: torch.from_numpy(v).to(dev) for k, v in spec["window"].items()}
    init = {k: v.clone() for k, v in model.lora.state_dict().items()}

    def train_step(ctx=None):
        model.lora.load_state_dict(init)
        _, step = blip2_train.make_lora_train_step(
            model, acc_steps=TP_ACC, compute_dtype=torch.bfloat16, mesh=mesh)
        with ctx or contextlib.nullcontext():
            loss = float(step(win))
        torch.cuda.synchronize()
        return loss, {n: p.grad.detach().float().cpu()
                      for n, p in model.lora.named_parameters()}

    _zero_counters()
    out["loss"], out["grads"] = train_step()
    out["train_launches"] = _read_counters()
    if control:
        out["controls"] = [train_step(opt_attention(
            model, ulp=2.0 ** -8, seed=SEED + 2005 + i))
            for i in range(VLM_CONTROL_DRAWS)]
    t1 = time.perf_counter()
    train_step()
    out["step_s"] = time.perf_counter() - t1
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del model, win
    return out


def sp_text_run(argv):
    """``cli.test_text.main(argv)`` in the current directory with the
    head's logits and each batch's step timed by CUDA events: (logits
    fp32 [batches x B, 4], preds, ms a batch, (csv name, bytes))."""
    import torch

    from garbage_classification_rca_tpu_torch.cli import test_text

    logits, ms, kept = [], [], []
    load, make = test_text.load_unimodal_model, test_text.make_text_eval_step
    evaluate = test_text.evaluate

    def load_hooked(*a, **k):
        model = load(*a, **k)
        model.head.register_forward_hook(
            lambda mod, i, o: logits.append(o.float().cpu()))
        return model

    def make_timed(*a, **k):
        step = make(*a, **k)

        def timed(batch):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            res = step(batch)
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
            return res

        return timed

    test_text.load_unimodal_model, test_text.make_text_eval_step = \
        load_hooked, make_timed
    test_text.evaluate = lambda args: kept.append(evaluate(args)) or kept[-1]
    try:
        test_text.main(argv)
    finally:
        test_text.load_unimodal_model, test_text.make_text_eval_step = \
            load, make
        test_text.evaluate = evaluate
    return torch.cat(logits), kept[0][2], ms, _report_csv(".")


def _serve_lines(argv, lines, primary=True):
    """``cli.serve.main(argv)`` on `lines` (rank 0's stdin); its output
    lines."""
    import io

    from garbage_classification_rca_tpu_torch.cli import serve

    stdout = io.StringIO()
    rc = serve.main(argv, stdin=io.StringIO(
        "\n".join(lines) + "\n" if primary else ""), stdout=stdout)
    return rc, stdout.getvalue().splitlines()


def tp_worker(spec_path: str) -> int:
    """A rank of phase 20 (``python3 chip_smoke.py --tp_worker=<spec>``,
    spawned by ``parallel.multihost.launch``): ``tp_path_work`` at
    ``model:2``, then ``cli.serve --mesh_shape=data:1,model:2`` and
    ``cli.test_text --mesh_shape=seq:2`` in this process, each rank's
    results written into the spec's ``out`` directory."""
    import gc
    import json as _json
    import os

    import torch

    from garbage_classification_rca_tpu_torch.parallel.multihost import (
        initialize_from_env, make_mesh)

    spec = torch.load(spec_path, weights_only=False)
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(initialize_from_env("cuda"), {"model": TP_RANKS})
    out = tp_path_work(mesh, spec)
    gc.collect()
    torch.cuda.empty_cache()
    for sub in ("serve", "text"):
        os.makedirs(os.path.join(spec["out"], f"{sub}{mesh.rank}"))
    _zero_counters()
    t0 = time.perf_counter()
    out["serve_rc"], lines = _in_dir(
        os.path.join(spec["out"], f"serve{mesh.rank}"), _serve_lines,
        spec["serve_argv"] + ["--mesh_shape=data:1,model:2"],
        spec["serve_lines"], mesh.is_primary)
    torch.cuda.synchronize()
    out["serve_s"] = time.perf_counter() - t0
    out["serve_launches"] = _read_counters()
    out["serve_lines"] = [_json.loads(ln) for ln in lines]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lg, preds, ms, csv = _in_dir(
        os.path.join(spec["out"], f"text{mesh.rank}"), sp_text_run,
        spec["text_argv"] + ["--mesh_shape=seq:2"])
    out.update(text_logits=lg, text_preds=preds, text_ms=ms, text_csv=csv,
               text_s=time.perf_counter() - t0)
    torch.save(out, os.path.join(spec["out"], f"tp_rank{mesh.rank}.pt"))
    return 0


def _tp_kernels(device, mask132, mask136, results):
    """K2 at 16 x 132 x 1280 (16 heads of 80, causal, the path's mask)
    and K4a / K4b at 16 x 136 x 1280, bf16, the shapes a rank runs at
    ``model:2``: K2 against ``mha_reference`` at the one-flip bar
    (``_vlm_k2_tc``), the pair against the plain pair (``_vlm_pair_case``:
    the default plan on the tensor cores), then each timed beside its
    plain version, the library's attention and the bound."""
    import torch
    import torch.nn.functional as F

    from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

    gen = torch.Generator().manual_seed(SEED + 2001)
    h = TP_HEADS
    rows = {}
    b, n, d = mask132.shape[0], mask132.shape[1], 1280
    q, k, v = (torch.randn((b, n, d), generator=gen).to(
        device, torch.bfloat16) for _ in range(3))
    want = K.mha_reference(q, k, v, heads=h, mask=mask132, causal=True)
    errs, over = {}, {}
    ok = _vlm_k2_tc(K, q, k, v, h, mask132, True, want, "opt (model:2)",
                    "path", errs, over)
    ms = time_ms(lambda: K.mha(q, k, v, heads=h, mask=mask132,
                               causal=True))[0]
    plain = time_ms(lambda: K.mha_reference(q, k, v, heads=h, mask=mask132,
                                            causal=True))[0]
    allowed = mask132.bool()[:, None, :] & torch.ones(
        (n, n), dtype=torch.bool, device=device).tril()[None]
    bias = torch.where(allowed, 0.0, K.NEG).to(torch.bfloat16)[:, None]
    rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)  # noqa: E731
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        rs(q), rs(k), rs(v), attn_mask=bias))[0]
    rows["mha_tc"] = _fwd_row(
        "mha_tc_tp", ms, plain, lib, _k2_flops(b, n, d, mask132, True),
        4 * q.numel() * q.element_size() + mask132.numel() * 4,
        errs["tc_path"], 116, "bfloat16", shape=[b, n, d], heads=h,
        head_dim=d // h)
    rows["mha_tc"]["source"] = \
        "garbage_classification_rca_tpu_torch/csrc/flash_tc.cuh"
    n = mask136.shape[1]
    q, k, v, do = (torch.randn((b, n, d), generator=gen).to(
        device, torch.bfloat16) for _ in range(4))
    errs4 = {}
    ok &= _vlm_pair_case(K, q, k, v, do, h, mask136, None, ("tc", "tc"),
                         "path", errs4)
    o, lse = K.mha_fwd_lse(q, k, v, heads=h, mask=mask136, causal=True)
    tc = K.flash_plan(q.shape, h, q.dtype)
    ms_f = time_ms(functools.partial(K.launch_fwd_lse, tc, q, k, v, heads=h,
                                     mask=mask136, causal=True))[0]
    ms_b = time_ms(functools.partial(K.launch_flash_bwd, tc, q, k, v, o, do,
                                     lse, heads=h, mask=mask136,
                                     causal=True))[0]
    plain_f = time_ms(lambda: K.mha_fwd_lse_reference(
        q, k, v, heads=h, mask=mask136, causal=True))[0]
    plain_b = time_ms(lambda: K.mha_flash_bwd_reference(
        q, k, v, o, do, lse, heads=h, mask=mask136, causal=True))[0]
    allowed = mask136.bool()[:, None, :] & torch.ones(
        (n, n), dtype=torch.bool, device=device).tril()[None]
    bias = torch.where(allowed, 0.0, K.NEG).to(torch.bfloat16)[:, None]
    bias = bias.expand(b, h, n, n).contiguous()
    eff = _efficient_attention(q, k, v, bias, h)
    lib_f = time_ms(lambda: _efficient_attention(q, k, v, bias, h))[0]
    rs = lambda a: a.view(b, n, h, d // h).transpose(1, 2)  # noqa: E731
    lib_b = time_ms(lambda: torch.ops.aten.
                    _scaled_dot_product_efficient_attention_backward(
                        rs(do), rs(q), rs(k), rs(v), bias, eff[0], eff[1],
                        eff[2], eff[3], 0.0, [True, True, True, False]))[0]
    del eff, bias
    fl_f, by_f, fl_b, by_b = _vlm_train_bound(q, mask136)
    for key, name, line, t, pl, lb, fl, by, side in (
            ("mha_fwd_lse_tc", "mha_fwd_lse_tp", 274, ms_f, plain_f, lib_f,
             fl_f, by_f, "fwd"),
            ("mha_flash_bwd_tc", "mha_flash_bwd_tp", 317, ms_b, plain_b,
             lib_b, fl_b, by_b, "bwd")):
        rows[key] = _fwd_row(name, t, pl, lb, fl, by,
                             max(e[side] for e in errs4.values()), line,
                             "bfloat16", shape=[b, n, d], heads=h,
                             head_dim=d // h)
    for key, r in rows.items():
        print(f"  {r['name']} {r['shape']}, {h} heads of {r['head_dim']} "
              f"(one rank's share at model:2): {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}), max|d| "
              f"{r['max_abs_err']:.3e}", flush=True)
    results["tp_kernels"] = rows
    return ok


def _tp_hold(one, ranks, aft):
    """(ok, numbers, line) of (a)-(c): rank 0 against the one-rank run,
    the ranks against each other."""
    import torch

    lo, lt = one["logits"], ranks[0]["logits"]
    d_vocab = float((lt - lo).abs().max())
    d_ans = float((lt[:, aft] - lo[:, aft]).abs().max())
    top2 = lo[:, aft].topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    floor = 2.0 * d_ans
    keep = margin > floor
    agree = bool((lt[:, aft].argmax(-1) == lo[:, aft].argmax(-1))[keep].all())
    a_ok = agree and d_ans <= TP_LOGIT_BAR and bool(torch.isfinite(lt).all())
    b_ok, streams = near_tie_agree(ranks[0]["tokens"], one["tokens"],
                                   one["margins"], 2.0 * d_vocab)
    g = dp_card_errors(ranks[0]["grads"], one["grads"])
    ctl_g = max(max(dp_card_errors(cg, one["grads"]).values())
                for _, cg in one["controls"])
    g_bar = max(DP_FP32_BARS["grad"], DP_CONTROL_FACTOR * ctl_g)
    loss_d = abs(ranks[0]["loss"] - one["loss"])
    ctl_d = max(abs(cl - one["loss"]) for cl, _ in one["controls"])
    loss_bar = max(DP_BF16_LOSS * abs(one["loss"]), DP_CONTROL_FACTOR * ctl_d)
    c_ok = loss_d <= loss_bar and max(g.values()) <= g_bar
    same = (torch.equal(ranks[0]["logits"], ranks[1]["logits"])
            and torch.equal(ranks[0]["tokens"], ranks[1]["tokens"])
            and all(torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k])
                    for k in ranks[0]["grads"]))
    nums = {"a": {"max_logit_diff_answers": d_ans,
                  "max_logit_diff_vocab": d_vocab, "floor": floor,
                  "above_floor": int(keep.sum()), "agree": agree,
                  "bar": TP_LOGIT_BAR, "ok": a_ok},
            "b": {**streams, "ok": b_ok},
            "c": {"loss": ranks[0]["loss"], "loss_one_rank": one["loss"],
                  "loss_diff": loss_d, "loss_bar": loss_bar,
                  "control_loss_diff": ctl_d, "grad_worst": max(g.values()),
                  "grad_bar": g_bar, "control_grad_worst": ctl_g,
                  "worst": sorted(g, key=g.get)[-3:], "ok": c_ok},
            "ranks_identical": same}
    top = sorted(g, key=g.get)[-2:]
    line = (f"(a) answer logits max|d| {d_ans:.3e} (bar {TP_LOGIT_BAR}), "
            f"vocab {d_vocab:.3e}; argmax agrees on the {int(keep.sum())} of "
            f"{len(keep)} rows above the floor {floor:.3e}: {agree}; (b) "
            + _stream_line("model:2 vs one rank", streams)
            + f"; (c) loss {ranks[0]['loss']:.6f} vs {one['loss']:.6f} (|d| "
            f"{loss_d:.2e}, bar {loss_bar:.2e}: bf16 1e-3 or 1.5x the "
            f"control's {ctl_d:.2e}), worst adapter gradients "
            f"{[(n, float(f'{g[n]:.3g}')) for n in top]} (bar {g_bar:.2e}, "
            f"1.5x the one-ulp control's {ctl_g:.2e}, the largest of "
            f"{len(one['controls'])} draws); the two "
            f"ranks' logits, tokens and gradients identical: {same}")
    return a_ok and b_ok and c_ok and same, nums, line


def check_model_seq_parallel(device, results, smi_line):
    """Phase 20: blip2-opt-2.7b at ``model:2`` and DistilBERT at ``seq:2``
    over two ranks sharing the card (gloo), in one launch
    (``tp_worker``), each held to the one-rank run of the same inputs in
    this process: (a) the 1-token eval, (b) ``generate``, (c) a LoRA step
    (``tp_path_work``, ``_tp_hold``), (d) their times and peak memory per
    rank (reported), (e) ``cli.serve --mesh_shape=data:1,model:2`` on 8 of
    phase 17's requests (lines held by the near-tie rule against each
    request's one-rank B = 1 generate, and against the one-rank server),
    (f) ``cli.test_text --text_model=distilbert --mesh_shape=seq:2`` at
    ``--seq_len=512`` on 24 texts (logits within the bf16 bar, argmax
    above the near-tie floor, the CSV). K2, K4a and K4b at a rank's
    16 heads of 80 are held to their plain versions first
    (``_tp_kernels``)."""
    import gc
    import json as _json
    import os
    import shutil

    import numpy as np
    import torch

    from garbage_classification_rca_tpu_torch.cli import serve
    from garbage_classification_rca_tpu_torch.cli.blip2_common import (
        build_blip2)
    from garbage_classification_rca_tpu_torch.config import args_parser
    from garbage_classification_rca_tpu_torch.data.images import (
        blip_preprocess_image)
    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        get_tokenizer)
    from garbage_classification_rca_tpu_torch.models.registry import (
        get_text_model)

    t_phase = time.perf_counter()
    print(f"  budget {PHASE20_BUDGET_S:.0f} s; {smi_line}", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "runs", "chip_smoke_tp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        tok = get_tokenizer("opt")
        data = SyntheticVLMBatcher(TP_BATCH * (1 + TP_ACC), tok, SEED + 2000)
        ev = data.batch(0, TP_BATCH)
        window = {k: np.stack([data.batch(TP_BATCH * (1 + i), TP_BATCH)[k]
                               for i in range(TP_ACC)])
                  for k in ("image", "input_ids", "attention_mask",
                            "valid")}
        rng = np.random.default_rng(SEED + 2002)
        window["label_tokens"] = rng.integers(
            3, 50000, (TP_ACC, TP_BATCH, VLM_LABEL_TOKENS)).astype(np.int32)
        window["label_tokens"][:, ::3, 2:] = 1          # PAD_ID
        n_query = 32
        dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        mask132 = torch.cat([torch.ones((TP_BATCH, n_query),
                                        dtype=torch.int32),
                             torch.from_numpy(ev["attention_mask"])],
                            1).to(device)
        lt = torch.from_numpy(window["label_tokens"][0])
        mask136 = torch.cat([mask132.cpu(), (lt != 1).to(torch.int32)],
                            1).to(device)
        ok = _tp_kernels(device, mask132, mask136, results)
        del mask132, mask136
        # (e) / (f) inputs
        _write_jpeg_tree(os.path.join(work, "garbage"), 0, 16, SEED + 710,
                         size=320)
        vocab = os.path.join(here, "tests", "fixtures", "vocab", "wordpiece")
        _write_jpeg_tree(os.path.join(work, "text"), 0, SP_TEXTS,
                         SEED + 2010, size=32, vocab=[
                             w for w in get_tokenizer(
                                 "distilbert", vocab_dir=vocab).vocab
                             if w.isalpha()])
        ckpt = os.path.join(work, "distilbert.pth")
        torch.save(_reference_state_dict(get_text_model("distilbert").build(
            4, generator=torch.Generator().manual_seed(SEED + 2011)),
            "distilbert"), ckpt)
        imgs = sorted(os.path.join(r, f) for r, _, fs in os.walk(
            os.path.join(work, "garbage_Val")) for f in fs)[:4]
        reqs = [{"id": f"t{i}", "text": f"Question: which bin takes a "
                 f"{VLM_ITEMS[i]}? Answer:", "max_new": 2 + i}
                for i in range(4)]
        reqs += [{"id": f"i{i}", "text": "Question: which bin? Answer:",
                  "image": p, "max_new": 8 - i} for i, p in enumerate(imgs)]
        lines = [_json.dumps(r) for r in reqs]
        serve_argv = [f"--max_new_tokens={TP_SERVE_NEW}", "--seed=7"]
        text_argv = ["--text_model=distilbert", f"--model_path={ckpt}",
                     f"--dataset_folder_name={work}/text_Val",
                     f"--vocab_dir={vocab}", "--eval_batch_size=16",
                     f"--seq_len={SP_SEQ_LEN}", "--compute_dtype=bfloat16"]
        spec = {"seed": SEED + 2003, "eval": ev, "window": window,
                "out": work, "serve_argv": serve_argv, "serve_lines": lines,
                "text_argv": text_argv}
        spec_path = os.path.join(work, "tp_spec.pt")
        torch.save(spec, spec_path)
        # the one-rank runs
        from garbage_classification_rca_tpu_torch.parallel.mesh import (
            DataMesh)

        t0 = time.perf_counter()
        one = tp_path_work(DataMesh(0, 1, device), spec, control=True)
        gc.collect()
        torch.cuda.empty_cache()
        os.makedirs(os.path.join(work, "serve_one"))
        _zero_counters()
        rc1, lines1 = _in_dir(os.path.join(work, "serve_one"), _serve_lines,
                              serve_argv, lines)
        one_serve_launches = _read_counters()
        # each request's B = 1 generate on the CLI's model: the margins of
        # the near-tie rule
        sargs = args_parser(serve_argv)
        cfg, m16, stok = build_blip2(sargs, device, torch.bfloat16)
        embed = serve._build_embedders(cfg, m16, sargs, stok,
                                       torch.bfloat16)
        pixs = [blip_preprocess_image(r["image"]).astype(np.uint8)
                if r.get("image") else None for r in reqs]
        alone = []
        with torch.inference_mode():
            for r, (e, m) in zip(reqs, embed(reqs, pixs)):
                want, marg = _alone(m16.opt, m16.lora, cfg.lora_scale, e,
                                    dev(m), sargs.max_prompt, TP_SERVE_NEW,
                                    r["max_new"], 2)
                if len(want) and int(want[-1]) == 2:   # the CLI strips it
                    want, marg = want[:-1], marg[:-1]
                alone.append((want, marg))
        del m16, embed
        gc.collect()
        torch.cuda.empty_cache()
        os.makedirs(os.path.join(work, "text_one"))
        tlg1, tpred1, tms1, tcsv1 = _in_dir(os.path.join(work, "text_one"),
                                            sp_text_run, text_argv)
        one_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launched, _ = dp_launch([os.path.abspath(__file__),
                                 f"--tp_worker={spec_path}"], TP_RANKS,
                                work, backend="gloo", share_device=True,
                                timeout=600)
        two_s = time.perf_counter() - t0
        if not launched:
            return False
        ranks = [torch.load(os.path.join(work, f"tp_rank{r}.pt"),
                            weights_only=False) for r in range(TP_RANKS)]
        aft = torch.as_tensor(_vlm_answer_tokens(tok)).long()
        held, nums, line = _tp_hold(one, ranks, aft)
        runs = [(w, r[f"{w}_launches"]) for r in ranks
                for w in ("eval", "gen", "train")]
        want_l = {"eval": TP_LAUNCHES["eval"], "gen": TP_LAUNCHES["generate"],
                  "train": TP_LAUNCHES["train"]}
        ran = all(_shown(got) == want_l[w] for w, got in runs) and all(
            _shown(one[f"{w}_launches"]) == want_l[w]
            for w in ("eval", "gen", "train"))
        print(f"  model:2 over two ranks sharing the card (gloo), "
              f"blip2-opt-2.7b bf16: {line}", flush=True)
        print(f"  launches a rank: eval {_shown(ranks[0]['eval_launches'])}"
              f", generate {_shown(ranks[0]['gen_launches'])}, LoRA step "
              f"{_shown(ranks[0]['train_launches'])} (one rank: "
              f"{_shown(one['eval_launches'])}, "
              f"{_shown(one['gen_launches'])}, "
              f"{_shown(one['train_launches'])}) "
              f"{'ok' if ran else 'FAIL'}", flush=True)
        perf = {w: {"one_rank": one[k], "per_rank": [r[k] for r in ranks]}
                for w, k in (("eval_s", "eval_s"), ("generate_s", "gen_s"),
                             ("lora_step_s", "step_s"),
                             ("peak_gib", "peak_gib"),
                             ("build_peak_gib", "build_peak_gib"),
                             ("build_s", "build_s"))}
        print(f"  (d) bf16, one rank vs each of two ranks sharing the card: "
              f"eval {TP_BATCH / one['eval_s']:.1f} vs "
              f"{[round(TP_BATCH / r['eval_s'], 1) for r in ranks]} "
              f"samples/s; generate {TP_BATCH * TP_NEW / one['gen_s']:.1f} "
              f"vs {[round(TP_BATCH * TP_NEW / r['gen_s'], 1) for r in ranks]}"
              f" tokens/s; LoRA step (acc {TP_ACC} x {TP_BATCH}) "
              f"{one['step_s']:.2f} vs {[round(r['step_s'], 2) for r in ranks]}"
              f" s; peak after the slicing {one['peak_gib']:.2f} vs "
              f"{[round(r['peak_gib'], 2) for r in ranks]} GiB (building the "
              f"whole model first: {one['build_peak_gib']:.2f} vs "
              f"{[round(r['build_peak_gib'], 2) for r in ranks]})",
              flush=True)
        # (e)
        by_id = {a["id"]: a for a in ranks[0]["serve_lines"]}
        one_by_id = {_json.loads(a)["id"]: _json.loads(a) for a in lines1}
        same = cut = 0
        bad = []
        floor = 2.0 * nums["a"]["max_logit_diff_vocab"]
        for r, (want, marg) in zip(reqs, alone):
            for got in (by_id.get(r["id"], {}), one_by_id.get(r["id"], {})):
                a_ok, a = _agree_one(got.get("tokens", []), want, marg,
                                     floor)
                if not a_ok:
                    bad.append(r["id"])
            same += by_id.get(r["id"], {}).get("tokens") == one_by_id.get(
                r["id"], {}).get("tokens")
        e_ok = (rc1 == 0 and all(r["serve_rc"] == 0 for r in ranks)
                and set(by_id) == set(one_by_id) == {r["id"] for r in reqs}
                and not ranks[1]["serve_lines"] and not bad)
        print(f"  (e) cli.serve --mesh_shape=data:1,model:2 on {len(reqs)} "
              f"requests in {ranks[0]['serve_s']:.1f} s: {same} of "
              f"{len(reqs)} lines identical to the one-rank server's, every "
              f"line held to its request's one-rank generate by the near-tie"
              f" rule (floor {floor:.3e}): {not bad}; launches rank 0 "
              f"{_shown(ranks[0]['serve_launches'])}, rank 1 "
              f"{_shown(ranks[1]['serve_launches'])} (one rank "
              f"{_shown(one_serve_launches)}) {'ok' if e_ok else 'FAIL'}",
              flush=True)
        # (f)
        n = SP_TEXTS
        lg2, pred2 = ranks[0]["text_logits"][:n], ranks[0]["text_preds"]
        tlg1 = tlg1[:n]
        d_txt = float((lg2 - tlg1).abs().max())
        top2 = tlg1.topk(2, dim=-1).values
        tfloor = 2.0 * d_txt
        near = (top2[:, 0] - top2[:, 1]) <= tfloor
        differ = torch.from_numpy(np.asarray(pred2) != np.asarray(tpred1))
        f_ok = (d_txt <= TP_LOGIT_BAR and not bool((differ & ~near).any())
                and torch.equal(ranks[0]["text_logits"],
                                ranks[1]["text_logits"])
                and (ranks[0]["text_csv"] == tcsv1 or bool(differ.any())))
        print(f"  (f) cli.test_text --text_model=distilbert --seq_len="
              f"{SP_SEQ_LEN} --mesh_shape=seq:2 on {n} texts (bf16): logits "
              f"max|d| {d_txt:.3e} (bar {TP_LOGIT_BAR}) against one rank, "
              f"{int(differ.sum())} predictions differ ({int(near.sum())} "
              f"rows at a near tie, floor {tfloor:.3e}); report "
              f"{'byte-identical' if ranks[0]['text_csv'] == tcsv1 else 'DIFFERS'}"
              f"; device ms a batch (CUDA events around the step): one rank "
              f"{[round(x, 3) for x in tms1]}, seq:2 rank 0 "
              f"{[round(x, 3) for x in ranks[0]['text_ms']]} "
              f"{'ok' if f_ok else 'FAIL'}", flush=True)
        secs = time.perf_counter() - t_phase
        results["model_seq_parallel"] = {
            "held": line, **nums, "launches_ok": ran, "perf": perf,
            "serve": {"identical_to_one_rank": same, "disagreeing": bad,
                      "seconds": ranks[0]["serve_s"], "floor": floor,
                      "ok": e_ok},
            "test_text_seq2": {"max_logit_diff": d_txt,
                               "predictions_differ": int(differ.sum()),
                               "near_ties": int(near.sum()),
                               "csv_identical": ranks[0]["text_csv"] == tcsv1,
                               "ms_per_batch_one_rank": tms1,
                               "ms_per_batch_seq2": [r["text_ms"]
                                                     for r in ranks],
                               "ok": f_ok},
            "seconds": {"one_rank": one_s, "two_ranks": two_s,
                        "phase": secs, "budget": PHASE20_BUDGET_S},
            "card": smi_line}
        results["tp_launches"] = {k: ranks[0]["eval_launches"].get(k, 0)
                                  + ranks[0]["gen_launches"].get(k, 0)
                                  + ranks[0]["train_launches"].get(k, 0)
                                  for k in ranks[0]["eval_launches"]}
        print(f"  phase 20 in {secs:.1f} s of its {PHASE20_BUDGET_S:.0f} s "
              f"budget (one rank {one_s:.1f} s, the two-rank launch "
              f"{two_s:.1f} s)", flush=True)
        return ok and held and ran and e_ok and f_ok
    finally:
        shutil.rmtree(work, ignore_errors=True)


def ptxas_report(log: str):
    """(kernel, "Used ... registers ..." line, spill line) for each entry
    function in an nvcc ``-Xptxas -v`` log; the tensor-core GEMMs are
    named by tile width and epilogue (their shared memory is dynamic:
    ``tc::Cfg<BN>::SMEM``, 197,696 bytes at 256, 205,904 at 192)."""
    import re

    out, entry, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            g = re.search(r"gemm_kernelILi(\d+)E.*?(HiddenEpi|ResidualEpi|"
                          r"QkvEpi)(?:ILb(\d))?", name)
            if g:
                epi = {"HiddenEpi0": "GEMM1 gelu", "HiddenEpi1": "GEMM1 relu",
                       "ResidualEpi0": "residual pre-norm",
                       "ResidualEpi1": "residual post-norm",
                       "QkvEpi": "attention QKV"}[g[2] + (g[3] or "")]
                entry = f"gemm_kernel<{g[1]}> ({epi})"
            elif re.search(r"3ftc\d+wide_kernelILi(\d+)ELb(\d)ELb(\d)ELb"
                           r"(\d)E", name):
                # the tensor-core forward at head dims 80 / 88 (K2, K4a)
                f = re.search(r"wide_kernelILi(\d+)ELb(\d)ELb(\d)ELb(\d)E",
                              name)
                entry = (f"wide_kernel<dh={f[1]}, masked={f[2]}, causal="
                         f"{f[3]}, lse={f[4]}> (tc)")
            elif re.search(r"3ftc\d+(\w+?_kernel)ILb(\d)ELb(\d)E", name):
                f = re.search(r"3ftc\d+(\w+?_kernel)ILb(\d)ELb(\d)E"
                              r"(?:Lb(\d)E)?", name)
                # the tensor-core forward (lse=1: K4a, 0: K2) and K4b
                lse = f", lse={f[4]}" if f[4] else ""
                entry = f"{f[1]}<masked={f[2]}, causal={f[3]}{lse}> (tc)"
            elif re.search(r"4tc32\d+(\w+?_kernel)ILb(\d)ELb(\d)ELb(\d)E",
                           name):
                f = re.search(r"4tc32\d+(\w+?_kernel)ILb(\d)ELb(\d)ELb"
                              r"(\d)E", name)
                # the fp32 backward on 3xTF32 (K4b, K7b with drop=1)
                entry = (f"{f[1]}<masked={f[2]}, causal={f[3]}, "
                         f"drop={f[4]}> (tc32)")
            elif re.search(r"(mha_kernel|mha_bwd_dq_kernel|"
                           r"mha_bwd_dkdv_kernel)I(f|13__nv_bfloat16)Li(\d+)E",
                           name):
                # K2 / K4a / K7a <T, DH, lse, drop>, K4b / K7b <T, DH, drop>
                g = re.search(r"(mha_kernel|mha_bwd_dq_kernel|"
                              r"mha_bwd_dkdv_kernel)I(f|13__nv_bfloat16)"
                              r"Li(\d+)E((?:Lb\dE)*)", name)
                flags = "".join(f", {x}" for x in re.findall(r"Lb(\d)E",
                                                             g[4]))
                entry = (f"{g[1]}<{'float' if g[2] == 'f' else 'bf16'}, "
                         f"{g[3]}{flags}>")
            else:  # the mangled <length><identifier> that ends in _kernel
                cands = (name[i:i + int(name[j:i])]
                         for i in range(1, len(name))
                         for j in range(max(0, i - 3), i)
                         if name[j:i].isdigit() and not name[i].isdigit())
                entry = next((c for c in cands if c.endswith("_kernel")
                              or c in RCA_BWD_STAGES + RCA_FWD_STAGES),
                             name[:60])
            continue
        if "spill" in line:
            spills = line.strip()
        m = re.search(r"Used \d+ registers.*", line)
        if m and entry is not None:
            out.append((entry, m.group(0), spills))
            entry, spills = None, ""
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return _fail("CUDA is not available")
    try:
        from garbage_classification_rca_tpu_torch.kernels import _build
    except ImportError as e:
        return _fail(f"the port's package is missing ({e})")
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False

    print("[1/20] device", flush=True)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi unavailable"
    print(f"  {name}; {smi_line}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    print("[2/20] build", flush=True)
    t0 = time.perf_counter()
    try:
        logs = _build.build_all()
    except Exception as e:  # noqa: BLE001 — reported, run fails
        return _fail(f"build: {e}")
    print(f"  built {sorted(logs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for n, log in logs.items():
        for entry, used, spills in ptxas_report(log):
            print(f"  {n}: {entry}: {used}; {spills}", flush=True)

    print("[3/20] kernels vs plain versions", flush=True)
    report = {}
    try:
        ok = check_rca(device, report)
        ok &= check_mha(device, report)
        ok &= check_rca_bwd(device, report)
        ok &= check_mha_train(device, report)
        ok &= check_mha_drop(device, report)
        ok &= check_postnorm_blocks(device, report)
        ok &= check_prenorm_blocks(device, report)
    except Exception as e:  # noqa: BLE001 — reported, run fails
        import traceback

        traceback.print_exc()
        return _fail(f"kernels: {type(e).__name__}: {e}")
    if not ok:
        return _fail("a kernel disagrees with its plain version")
    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)",
          flush=True)

    results = {}
    for title, check in (
            ("[4/20] MM-RCA eval path",
             lambda: check_model(device, N_BATCHES, BATCH, results)),
            ("[5/20] MM-RCA train path: full-width train step",
             lambda: check_train(device, results)),
            ("[5/20] MM-RCA train path: cli.main_both -> cli.test_both",
             lambda: check_cli(device, results)),
            ("[6/20] text eval path: BERT-base, DistilBERT, RoBERTa",
             lambda: check_text_eval(device, results)),
            ("[7/20] image eval path: ViT-B/16",
             lambda: check_image_eval(device, results)),
            ("[7/20] unimodal eval CLIs: cli.test_text, cli.test_image",
             lambda: check_eval_clis(device, results)),
            ("[8/20] text train path: DistilBERT and BERT-base with "
             "hf_internal_dropout",
             lambda: check_text_train(device, results)),
            ("[9/20] image train path: ViT-B/16",
             lambda: check_image_train(device, results)),
            ("[9/20] unimodal train CLIs: cli.main_text -> cli.test_text, "
             "cli.main_image -> cli.test_image",
             lambda: check_train_clis(device, results)),
            ("[10/20] conv image eval: ShuffleNetV2 x2.0, then ResNet, "
             "MobileNetV3, ConvNeXt, EfficientNet v1 / v2",
             lambda: check_conv_eval(device, results)),
            ("[10/20] conv image eval CLI: cli.test_image "
             "--image_model=shuffle_net",
             lambda: check_conv_cli(device, results)),
            ("[11/20] fusion eval: gated, classic, normalized, clip, "
             "hierarchical, bimodal; DistilBERT, BERT and BART-large towers",
             lambda: check_fusion_eval(device, results)),
            ("[11/20] fusion eval CLIs: cli.test_both (gated, clip), "
             "cli.test_text --text_model=bart",
             lambda: check_fusion_clis(device, results)),
            ("[12/20] VLM eval: BLIP-2 and the Q-Former (EVA ViT-g, "
             "Q-Former, OPT-2.7B; K2 at head dims 88 and 80)",
             lambda: check_vlm_eval(device, results)),
            ("[12/20] VLM eval CLIs: cli.blip2_test, cli.qformer_test",
             lambda: check_vlm_clis(device, results)),
            ("[13/20] VLM train: BLIP-2 LoRA (K4a / K4b at head dim 80) "
             "and the Q-Former classifier",
             lambda: check_vlm_train(device, results)),
            ("[13/20] VLM train CLIs: cli.blip2_train -> cli.blip2_test, "
             "cli.qformer_train -> cli.qformer_test",
             lambda: check_vlm_train_clis(device, results)),
            ("[13/20] VLM RESUME: cli.blip2_train and cli.qformer_train "
             "killed at the epoch boundary and mid-epoch, resumed with "
             "--resume_from, held to a control",
             lambda: check_vlm_resume(device, results)),
            ("[14/20] late-fusion train: gated, classic, normalized, clip, "
             "hierarchical, bimodal on DistilBERT and BERT, MM_RCA on BERT, "
             "gated, classic, normalized, clip on BART-large",
             lambda: check_fusion_train(device, results)),
            ("[14/20] late-fusion train CLIs: cli.main_both (hierarchical + "
             "BERT, clip + BART) -> cli.test_both, cli.main_text "
             "--text_model=bart -> cli.test_text",
             lambda: check_fusion_train_clis(device, results)),
            ("[15/20] text family: GPT-2 and MobileBERT at full width and "
             "depth (no hand-written kernel)",
             lambda: check_text_family(device, results)),
            ("[15/20] text family CLIs: cli.main_text "
             "--hf_internal_dropout -> cli.test_text (gpt2, mobilebert)",
             lambda: check_text_family_clis(device, results)),
            ("[16/20] conv train: the 12 conv backbones, a step each; "
             "fp64 and fp32 card vs CPU",
             lambda: check_conv_train(device, results)),
            ("[16/20] conv train CLI and RESUME: cli.main_image res18 -> "
             "cli.test_image; cli.main_both MM_RCA and cli.main_image res18 "
             "killed and resumed, held to a control",
             lambda: check_resume(device, results)),
            ("[17/20] serving: BLIP-2 generate (bf16, fp32, int8 cache and "
             "weights; K2 in every prefill), the continuous-batching server, "
             "speculative decoding",
             lambda: check_serving(device, results)),
            ("[17/20] serving CLIs: cli.blip2_test --max_new_tokens=4 "
             "(greedy, sampled, int8), cli.serve",
             lambda: check_serving_clis(device, results)),
            ("[18/20] paraphraser: the Llama behind GC_RCA_LLM_PATH at "
             "Llama-3.1-8B-Instruct's width, card vs CPU, cli.main_text "
             "--use_synonyms",
             lambda: check_paraphraser(device, results)),
            ("[19/20] data parallelism: the MM-RCA train step over two "
             "ranks sharing the card (gloo), cli.main_both -> cli.test_both "
             "over two ranks, cli.main_text --fsdp on NCCL",
             lambda: check_data_parallel(device, results, smi_line)),
            ("[20/20] tensor and sequence parallelism: blip2-opt-2.7b at "
             "model:2 (eval, generate, a LoRA step, cli.serve) and "
             "cli.test_text at seq:2 over two ranks sharing the card (gloo)",
             lambda: check_model_seq_parallel(device, results, smi_line))):
        if title.startswith("[17/20] serving:"):
            results["phases_1_16_s"] = time.perf_counter() - t_start
            print(f"  (phases 1-16 in {results['phases_1_16_s']:.1f} s)",
                  flush=True)
        print(title, flush=True)
        t_phase = time.perf_counter()
        try:
            ok = check()
        except Exception as e:  # noqa: BLE001 — reported, run fails
            import traceback

            traceback.print_exc()
            return _fail(f"{title}: {type(e).__name__}: {e}")
        if not ok:
            return _fail(f"{title}: check failed")
        secs = time.perf_counter() - t_phase
        results.setdefault("phase_seconds", {})[title] = secs
        print(f"  ({secs:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start)",
              flush=True)
    # launches on each kernel's own main path: the MM-RCA eval path for K1 /
    # K2 (the tensor cores; the CUDA cores at --seq_len=512), its train path
    # for K3 / K4a / K4b (K1 runs on both; K4b on 3xTF32, the CUDA-core K4b
    # in the text trainer at seq 512 without dropout),
    # the text eval path for K5a / K5b, the image eval path for K6a / K6b
    # (K5a / K6a on the tensor cores, counted as "<name>_tc"; the CUDA-core
    # body, fp32, on the trainers' val evals),
    # the text train path (hf_internal_dropout) for K7a / K7b (3xTF32; the
    # CUDA-core K7a / K7b at seq 512), the image train path for the bf16
    # tensor-core K4a / K4b; every row also reads the late-fusion eval
    # path ("fusion_eval": K2 on the DistilBERT / BERT towers, K1 on the
    # BERT MM-RCA run), the VLM eval path ("vlm_eval": K2 on the CUDA
    # cores at head dims 88 and 80, 71 a BLIP-2 batch, 39 a Q-Former one)
    # and the late-fusion train path ("fusion_train": K4a / K4b on the
    # DistilBERT / BERT towers, K1 / K3 on MM-RCA with BERT; with
    # hf_internal_dropout K7a / K7b); "text_family" (GPT-2 and MobileBERT,
    # phase 15) reads 0 for every kernel; "serving" (phase 17's
    # GenerationServer run: K2 32 a prefill, on the tensor cores)
    by_path = {"eval": results["launches"], "train": results["train_launches"],
               "eval_seq512": results["launches_seq512"],
               "text_eval": results["text_eval_launches"],
               "image_eval": results["image_eval_launches"],
               "text_train": results["text_train_launches"],
               "text_train_flag_off":
                   results["text_train_flag_off_launches"],
               "text_train_seq512": results["text_train_seq512_on_launches"],
               "text_train_seq512_flag_off":
                   results["text_train_seq512_off_launches"],
               "image_train": results["image_train_launches"],
               "train_hf_dropout": results["train_hf_dropout_launches"],
               "conv_eval": results["conv_eval_launches"],
               "fusion_eval": results["fusion_eval_launches"],
               "vlm_eval": results["vlm_eval_launches"],
               "vlm_train": results["vlm_train_launches"],
               "fusion_train": results["fusion_train_launches"],
               "fusion_train_hf_dropout":
                   results["fusion_train_hf_launches"],
               "text_family": results["text_family_launches"],
               "serving": results["serving_launches"],
               "data_parallel_rank0": results["dp_launches"],
               "model_parallel_rank0": results["tp_launches"]}
    kernels = []
    for key, path in (("rca_fused", "eval"), ("mha_tc", "eval"),
                      ("mha", "eval_seq512"),
                      ("rca_fused_bwd", "train"), ("mha_fwd_lse", "train"),
                      ("mha_flash_bwd_tc32", "train"),
                      ("mha_flash_bwd", "text_train_seq512_flag_off"),
                      ("postnorm_attn_block", "text_eval"),
                      ("postnorm_mlp_block", "text_eval"),
                      ("attn_block", "image_eval"),
                      ("mlp_block", "image_eval"),
                      ("mha_fwd_lse_drop_tc32", "text_train"),
                      ("mha_fwd_lse_drop", "text_train_seq512"),
                      ("mha_flash_bwd_drop_tc32", "text_train"),
                      ("mha_flash_bwd_drop", "text_train_seq512"),
                      ("mha_fwd_lse_tc", "image_train"),
                      ("mha_flash_bwd_tc", "image_train")):
        row = dict(report[key])
        counter = key + "_tc" if key in ("postnorm_attn_block",
                                         "attn_block") else key
        row["launches"] = by_path[path][counter]
        row["launches_by_path"] = {p: c[counter] for p, c in by_path.items()}
        if counter != key:
            row["cuda_cores_launches_by_path"] = {p: c[key]
                                                  for p, c in by_path.items()}
        if key == "mha":
            row["vlm_shapes"] = results["vlm_k2"]
        if key in ("rca_fused", "rca_fused_bwd"):
            row["per_sample_launches_by_path"] = {
                p: c[key + "_per_sample"] for p, c in by_path.items()}
        kernels.append(row)
        if row["launches"] <= 0:
            return _fail(f"{key} was not launched on the {path} path")
    # K2 at head dims 88 / 80 on the tensor cores (ftc::wide_kernel, the
    # only attention of the VLM eval path: EVA 39 and OPT 32 a BLIP-2
    # batch, EVA 39 a Q-Former batch), timed in phase 12; K4a and K4b at
    # head dim 80 on the tensor cores (ftc::wide_kernel, dq_wide_kernel /
    # dkdv_wide_kernel: OPT-2.7B's LoRA training), timed in phase 13:
    # launched on the VLM paths, read from their counters
    k2 = results["vlm_k2"]
    tc_errs = [e for r in k2 for key, e in r["max_abs_err"].items()
               if key.startswith("tc_")]
    vlm_rows = [("mha_tc_vlm", "mha_tc", "vlm_eval", {
        "name": "mha_tc_vlm", "route": "cuda",
        "source": "garbage_classification_rca_tpu_torch/csrc/flash_tc.cuh",
        "replaces": "garbage_classification_rca_tpu/kernels/mha_fused.py:91",
        "max_abs_err": max(tc_errs),
        **{key: k2[0][key] for key in (
            "ms", "ms_runs", "cuda_core_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "share_of_bound", "shape", "heads",
            "head_dim", "over_one_ulp_1e-3")},
        "other_shapes": k2[1:]})]
    for key, counter in (("mha_fwd_lse_hd80", "mha_fwd_lse_tc"),
                         ("mha_flash_bwd_hd80", "mha_flash_bwd_tc")):
        vlm_rows.append((key, counter, "vlm_train",
                         results["vlm_train_kernels"][key]))
    # and at a rank's 16 heads of 80 under model:2 (phase 20)
    for key, counter, path, row in vlm_rows:
        row = dict(row)
        row["model_parallel_16_heads"] = results["tp_kernels"][counter]
        row["launches"] = by_path[path][counter]
        row["launches_by_path"] = {p: c[counter] for p, c in by_path.items()}
        kernels.append(row)
        if row["launches"] <= 0:
            return _fail(f"{key} was not launched on the {path} path")
    print(json.dumps({"model": results["model"], "train": results["train"],
                      "text_eval": results["text_eval"],
                      "text_eval_others": {
                          k: results[f"text_eval_{k}"]
                          for k in ("distilbert", "roberta")},
                      "image_eval": results["image_eval"],
                      "eval_clis": results["eval_clis"],
                      "text_train": results["text_train"],
                      "image_train": results["image_train"],
                      "train_clis": results["train_clis"],
                      "conv_eval": results["conv_eval"],
                      "conv_eval_shuffle_net":
                          results["conv_eval_shuffle_net"],
                      "conv_cli": results["conv_cli"],
                      "fusion_eval": results["fusion_eval"],
                      "fusion_clis": results["fusion_clis"],
                      "vlm_eval": results["vlm_eval"],
                      "vlm_clis": results["vlm_clis"],
                      "vlm_train": results["vlm_train"],
                      "vlm_train_clis": results["vlm_train_clis"],
                      "fusion_train": results["fusion_train"],
                      "fusion_train_clis": results["fusion_train_clis"],
                      "text_family": results["text_family"],
                      "text_family_clis": results["text_family_clis"],
                      "conv_train": results["conv_train"],
                      "resume": results["resume"],
                      "serving": results["serving"],
                      "serving_clis": results["serving_clis"],
                      "vlm_resume": results["vlm_resume"],
                      "paraphraser": results["paraphraser"],
                      "data_parallel": {k: results[k] for k in (
                          "dp_step", "dp_clis", "dp_fsdp")},
                      "model_seq_parallel": results["model_seq_parallel"],
                      "phase_seconds": results["phase_seconds"],
                      "phases_1_16_s": results["phases_1_16_s"],
                      "seconds": time.perf_counter() - t_start,
                      "grad_checks": {k: results[k] for k in (
                          "grad_check_fp32", "grad_check_bf16")},
                      "card": smi_line}))
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1].startswith("--dp_step="):
        sys.exit(dp_step_worker(sys.argv[1].partition("=")[2]))
    if len(sys.argv) > 1 and sys.argv[1] == "--dp_eval":
        sys.exit(dp_eval_worker(sys.argv[2:]))
    if len(sys.argv) > 1 and sys.argv[1].startswith("--tp_worker="):
        sys.exit(tp_worker(sys.argv[1].partition("=")[2]))
    sys.exit(main())
