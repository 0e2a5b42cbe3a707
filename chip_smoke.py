#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``uurg_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Card, PyTorch, CUDA and nvcc versions.
2. Build every kernel under ``uurg_torch/csrc/`` (one nvcc per source, in
   parallel) and print the ptxas register/spill report.
3. Find the shapes the sampling path gives each kernel (hooks on one small
   forward of the full-width model), then at batch 256 (CFG 2 x 128) hold
   each kernel against its plain PyTorch version on the same bf16 inputs and
   time kernel, plain version and the PyTorch library call (SDPA,
   ``F.group_norm``) with CUDA events around a CUDA-graph replay (device
   time), and the kernel also launched eagerly from Python. The GroupNorm
   forward runs on the route its wrapper chooses by shape (``slab`` with its
   cluster size, or ``split`` with its runs a sample); at every shape the
   ``split`` route (the wrapper's runs a sample at this batch) is held
   against the plain version and timed too (``split_ms``).
4. One forward at batch 8 with the kernels against the same model on its
   plain path.
5. The sampling path: ``ddpm_runner.sample_images`` on the full-width
   ``configs/cifar10_sfron.yml`` CondUNet (seeded random init), DDIM-50 with
   classifier-free guidance 2.0, 128 labels over 10 classes. The kernel
   launch counters are zeroed just before and read just after; every
   attention and GroupNorm site must have gone through its kernel.
6. The backward kernels against their plain versions at every backward
   site shape of the training path (batch 128), timed as in phase 3: the
   kernel, its plain version, and the PyTorch library's backward alone
   (SDPA, ``F.group_norm``, forward graph retained). The attention forward
   with its log-sum-exp output, as the training path runs it, is held
   against the plain version and ``logsumexp`` and timed at the same shapes.
   The GroupNorm backward runs on the route its wrapper chooses (its
   cluster size recorded), and a CUDA graph of one of its calls must hold
   exactly its kernels: one on ``slab``, two on ``split``.
7. One eps-loss backward at batch 8 with the kernels against the same model
   on its plain path: relative L2 error of all parameter gradients.
8. The training path: ``ddpm_runner.sfron_forget`` (adaga, ron, a packed
   random mask of ~50% density) on the full-width config at batch 128 + 128
   on the synthetic CIFAR-10 stand-in: 2 warm-up steps, then 10 counted and
   timed steps that resume from the warm-up's ``ckpt.pth``. Losses must be
   finite, parameters and EMA must move, and every attention and GroupNorm
   site of both phases must have gone through its forward and backward
   kernels. The written ``ckpt.pth`` is then sampled (EMA) through
   ``sample_images``.
9. The attention kernels off the main path: ragged T (not a multiple of any
   tile, so TMA zero fill and key masking decide the result) and head
   widths that the wrapper pads, forward, log-sum-exp and backward against
   the plain versions, each run three times with equal bits.
10. The GroupNorm forward off the main path: fp32, slices of unequal
   length (H W not a multiple of the cluster), a sample too large for a
   cluster (the ``split`` route), narrow channels with halved groups, batch
   1, 2 and 3; y, mean and rstd against the plain version on the chosen
   route, on ``split`` (one run a sample, and the wrapper's count) and at
   every cluster size that fits, each run three times with equal bits.
11. The GroupNorm backward off the main path, the same way: fp32 and bf16,
   ragged slices (H = 5, 12), C = 24 with G = 8, a one-pixel sample, batch
   1, 3 and 40, and the main path's eleven shapes at batch 256 (the CFG
   double forward's batch that the Fisher pass backpropagates through);
   dx, dscale and dbias against the plain version on every route and
   cluster size that fits (``split`` at the wrapper's runs a sample and at
   one), three runs with equal bits.
12. Fisher and masks (stages 1 and 2 of the north-star run). The kernels at
   the Fisher pass's shapes: attention forward, log-sum-exp and backward at
   both attention sites at CFG batch 256, 124 and 132 (the ragged last
   batches of the forget and remain splits, doubled), GroupNorm forward and
   backward at the eleven site shapes at batch 124 and 132, against the
   plain versions, three runs with equal bits. One Fisher batch (batch 8,
   CFG 16) with the kernels against the same model on its plain path. Then
   ``ddpm_runner.generate_fisher`` over the whole stand-in splits (one pass,
   the ragged last batch kept, eval mode), with the launch counters zeroed
   just before and read just after: one forward and one backward of every
   attention and GroupNorm site a Fisher batch. The Fisher files must be
   finite, non-negative and not all zero; a Fisher batch is timed on the
   host clock and its device time profiled. ``generate_fisher_mask`` at
   three thresholds, ``sfron_forget`` for 2 steps under the ``fisher_1.0``
   file read from ``args.mask_path``, ``generate_salun_mask`` over the
   forget split (train mode, exact launch counts), and 2 SalUn steps
   (``rl`` under that mask).
13. Selective Amnesia (``configs/cifar10_sa.yml``). The kernels at the
   per-sample Fisher's batch (50 = T / 20 timesteps of one example):
   attention forward, log-sum-exp and backward, GroupNorm forward and
   backward at every site shape, against the plain versions, three runs
   with equal bits. One example's gradient (batch 50) with the kernels
   against the same model on its plain path. Then ``cli/fim.py``'s
   ``generate_fim`` at 20 chunks x 4 examples (batch 4) with the launch
   counters zeroed just before and read just after (one forward and one
   backward of every site an example); the ``fisher_dict`` it writes must
   be finite, non-negative and not all zero. ``ddpm_runner.sa_forget``
   from that file on the stand-in's remain split: 2 warm-up steps (one
   profiled for its device time), then 5 counted and timed steps (two
   eval-mode forwards at batch 128 and their backward a step); losses
   finite, the EWC term above 0 after the first step, parameters and EMA
   moved, exact launch counts.

14. Evaluation and the five stages end to end. InceptionV3 (seeded, fp32,
   TF32 off) at batch 4 from uint8 32x32 images through ``preprocess``, and
   the ResNet-34 probe (ImageNet stem, fp32) at 224 px, on the card against
   the same weights on the CPU: pool, spatial, logits and the probe's
   logits within relative error 1e-3. Their throughput: InceptionV3 at
   batch 256 by CUDA events and ``featurize`` over 2,048 images on the host
   clock; the probe in bf16 at batch 64. Then the twin of
   ``cli/parity_check.py`` through ``uurg_torch.cli.parity_check.run`` on
   the full-width config and the stand-in artifacts: the Fisher pass, the
   ``fisher_1.0`` mask, 2 SFR-on steps under it, 9 remaining-class and
   16 forgotten-class samples by DDIM-50 CFG, the metrics against the
   stand-in's remain split (1,858 references) and the UA probe. The launch
   counters are zeroed just before and read just after: one forward and
   backward of every site a Fisher batch, two a step, one forward a
   sampling step. Every metric finite, precision, recall and UA in [0, 1],
   IS at least 1, every band SKIPPED, the report and both npz files
   written; host seconds by stage and peak device memory printed.
14b. The north-star pipeline through the port's CLIs, as README.md gives
   the commands, each ``python -m uurg_torch.cli.<name>`` in a process of
   its own that reads what the one before it wrote (the processes share
   one bytecode cache, filled while the kernels build; each imports torch
   while the stage before it runs and gets its arguments when that stage
   has exited; phase 14's twin runs in this process meanwhile), at the
   config's full width on the stand-in data: ``train --mode
   pretrain`` (2 iterations), ``--mode generate_fisher --threshold 1.0``
   on its run, ``--mode sfron --method ron --unlearn_loss adaga
   --mask_path`` that mask (2 steps), ``sample --mode sample_fid`` (8 a
   class of the 9 kept, DDIM-50) on the forget run, ``evaluator`` on those
   samples against ``save_base_dataset``'s references (the seeded
   InceptionV3), ``classifier_evaluation`` with the probe that
   ``train_classifier`` writes in 2 steps at 32 px. Every process exits 0;
   the DDPM ones report their kernel launches (exact counts: a Fisher
   batch, a step, a DDIM step); the SFR-on process's ``ckpt.pth`` is held
   bit for bit to ``sfron_forget`` run in this process from the same
   checkpoint, mask, config and seed (else within SCAN_SPREAD times two
   in-process runs' own spread); the evaluator and classifier_evaluation
   run on beside phases 15-17 (EVAL_THREADS host threads each) and are
   reaped after phase 17: the evaluator's metrics finite and UA in
   [0, 1].
15. Classification unlearning on ResNet-18 (CIFAR stem, full width,
   seeded flax-style init), none of the four kernels on its path: the
   launch counters are zeroed at the start and must read 0 at the end.
   One train-mode CE step through SGD at batch 16 on the card against the
   CPU from the same weights, in fp32 with TF32 off (logits, loss,
   parameters after the step, running statistics and eval-mode logits
   within relative L2 1e-4, gradients within 5e-3, each side's fp32
   gradients' distance from float64 printed) and in float64 (all within
   1e-9). Then on a CIFAR-10-sized stand-in (50,000 + 10,000 images,
   random 10% forgetting, batch 256, the flip and pad-crop augmentation):
   ``SFRon`` through the registry (the Fisher pass over both splits
   timed, the mask density; cut from 1,500 iterations by its ``n_iters``
   override) on its chunked path, chunks of ``make_sfron_scan`` replayed
   as one CUDA graph each: in bf16 250 iterations at its default chunk of
   50 (the first chunk eager, the second, after its capture, held against
   the chunk's plain loop from the same state and seed: parameters,
   BatchNorm statistics, gradients, optimizer state and losses bit-equal,
   or within 4 times the plain loop's own run-to-run spread; the third
   profiled for the device's busy time; two timed on the host clock), in
   fp32 10 in chunks of 5 without the mask (the warm-up and the compared
   replay); then in bf16 step by step (``scan_chunk`` 1, 10 warm-up
   iterations of which 5 profiled, 50 timed; the Fishers read from the
   chunked run's files, as the method's cache reads them); losses
   finite, parameters and running
   statistics moved, forget and test accuracy and peak memory printed;
   the other eight methods through the registry at one epoch each in bf16
   on a tenth of the retain and forget splits (4,500 + 500 images; finite,
   parameters moved but for Baseline, running statistics moved where the
   model trains, the context's model untouched);
   ``uurg_torch.cli.main_random --unlearn_method SFRon --svc_mia --dtype
   bf16`` on its own 2,048 / 512-image stand-in in this process, its SFRon
   cut from 1,500 iterations to 250 (its CSV row, the rate it logs at
   iteration 250); the SVC attack's fit at 2,000 + 2,000 (the protocol
   caps it at 4,000 + 4,000) on the host. The float32 attention counters
   must read 0 too.
16. The float32 attention kernels (``uurg_torch/csrc/flash_attention_f32.cu``)
   with TF32 off: at ViT-B/16's (64, 12, 197, 64) (the tiled route) and
   main_random's (256, 12, 5, 64) (the packed route), at D = 40 and 160
   (padded), at the edges of the packed and tiled routes (T = 5, 16, 17,
   31, 33, 63, 65, 196, 197, 208 at D = 64 and 40) and at the ragged shapes
   of phase 9, the forward (relative L2 1e-5), its log-sum-exp against
   ``torch.logsumexp`` and the backward (1e-4) against the plain versions,
   each three times with equal bits; at the two ViT shapes the kernel,
   the plain version and float32 SDPA with its backward timed by
   CUDA-graph replay.
17. ViT-B/16 and Swin-T classification at 224 px. ViT_B in fp32 on the
   card against the CPU at batch 2 from the same weights (logits and all
   parameter gradients, each side's distance from float64 printed), its
   call exactly 12 + 12 float32 attention launches; ``SFRon`` through the
   registry at batch 64 on a 320-image 224 px stand-in (the Fisher pass,
   the mask) in fp32 (float32 counters exactly 12 a forward and 12 a
   backward, bf16 counters 0) and in bf16 (the reverse): 25 of 1,500
   iterations in chunks of 5 replayed as CUDA graphs (checked as phase
   15's; the launches counted as a capture's times its replays plus the
   eager warm-up's, and the loop's forwards one an iteration and one a
   forget step), then 3 + 10 step by step (``scan_chunk`` 1); Swin_T card
   against CPU and 3 SFR-on iterations with no attention launch; then
   each in this process:
   ``main_random --unlearn SFRon --model ViT_B`` on its 32 px stand-in
   (SFRon cut from 1,500 iterations to 10),
   ``save_base_dataset --as_npz``, ``train_classifier`` for one epoch (32
   steps at batch 64, 224 px) and ``classifier_evaluation`` reading its
   ``.pth`` on the npz.
Then the remat'd DDPM step: the full-width config in train mode at batch
   128 with ``model.remat`` against the same weights and generator without
   it (loss equal, gradients within 4 times the plain step's own run-to-run
   spread, which is bit-equality where that spread is 0; exactly 44 more
   GroupNorm forward launches; the peak memory of each), and
   ``sfron_forget`` for 4 steps with remat and an Adam second moment in
   bf16 against the same without remat (exact launch counts, step times,
   peak memory).
18. DiT-XL/2 class forgetting on pre-encoded ImageNet-256 latents (32 x 32
   x 4, T = 256 tokens, 16 heads of width 72, which the bf16 kernels read
   at that width and the fp32 dispatcher pads to 128). The bf16 attention
   kernels at (32, 16, 256, 72) (forward with and without its
   log-sum-exp, the log-sum-exp, backward) and the fp32 pair at
   (2, 16, 256, 72) (the wide route) against the plain versions, three runs
   with equal bits, the same bits on MHSA's layout (q, k, v views of one
   fused projection, a token-major gradient) as on contiguous inputs, no
   pad op on the bf16 route, timed on both layouts beside SDPA at D = 72
   and the bound of the true width. The full-width model (seeded init, then
   perturbed so that every adaLN gate is O(0.1-1)) in bf16 at batch 4,
   kernels against its plain path: the forward (a zeroed attention must
   move it) and the hybrid loss's gradients through full remat; four of its
   blocks in fp32 card against CPU at batch 2 (output and gradients, each
   side's distance from float64). Then on a stand-in of 2,048 seeded
   latents over 10 classes in 4 shards (``write_latent_shards``), each in
   this process, from a reference ``.pt`` of the seeded model perturbed
   (``--ckpt``): ``dit_generate_fisher`` (class 0, 2 batches of 1),
   ``dit_generate_mask`` (threshold 1.0), ``forget`` (the mask packed,
   adaga, 3 steps, snapshot and checkpoints at step 3; ``final.pt`` read
   back). ``dit_forget`` at batch 32 + 32 under that mask, 2 warm-up steps
   and one profiled, then 2 counted and timed, under full and ``attn``
   remat (attention launches exactly 28 + 28 or 28 forwards and 28
   backwards a phase; GroupNorm's 0; steps/s, busy share, peak memory);
   ``dit_sample_grid`` (50 steps, CFG 4.0, 16 labels; 28 forward launches
   a step).
19. DiT's frozen VAE (``VAEConfig()``, the CompVis first stage, fp32, TF32
   off, seeded init) at 256 px. (a) The float32 attention forward at head
   widths above 256 (the ``xwide`` route of ``flash_attention_f32.cu``) at
   T = 16, 100, 1024, 4096 and D = 512, 320 and 300 (padded to 320)
   against the plain version (relative L2 1e-5), its log-sum-exp, three
   runs with equal bits; at the VAE's (32, 1, 1024, 512) and SD's VAE's
   (2, 1, 4096, 512) timed by CUDA-graph replay and eagerly beside the
   plain version and fp32 SDPA under each backend that takes the shape
   (``torch.nn.attention.sdpa_kernel``; the fastest is the library column).
   (b) The GroupNorm forward (the ``split`` route, two launches a call) at
   each of the VAE's fp32 site shapes at batch 32, the 2^31-byte
   (32, 256, 256, 256) one included, against the plain version, three runs
   with equal bits, timed beside ``F.group_norm``; then, off the path, at
   SD's bf16 UNet sites that fit no cluster at batch 4 (``nsfw_removal``'s),
   checked and timed the same way. (c) One image encoded with
   fixed noise and decoded, card against CPU (1e-4); 32 images encoded and
   32 latents decoded with exact launch counts (1 float32 attention and 22
   GroupNorm forwards an encode, 1 and 30 a decode, every other counter 0),
   images/s and peak memory. (d) On a seeded PNG folder (4 classes x 16):
   ``encode_latents`` into shards (launches counted), ``forget`` one step
   from those shards and one from the image folder (the VAE in the loop),
   from phase 18's perturbed DiT-XL/2, then ``uurg_torch.cli.dit_sample
   --mode fid_npz`` in this process (64 labels, 32 a batch, 4 respaced
   steps): 64 uint8 256 px images, not constant.
19b. The ``xwide`` kernels at the padded head widths 320-512 in both
   dtypes: the float32 forward and backward, the bfloat16 forward (its
   source ``flash_attention_xwide_fwd.cu``, TMA and wgmma) and the backward
   in both (``flash_attention_xwide_bwd.cu``, on the tensor cores) at
   D = 320, 384, 448, 512 and T = 100, 256 and 16 (batch 2 x
   1 head) against the plain versions (float32: relative L2 1e-5 forward,
   1e-4 backward; bf16: ATOL / RTOL forward, BWD_REL_L2 backward), the
   log-sum-exp, three runs with equal bits and one launch a call on the
   route's counter; timed at the wide CondUNet's CFG forward (256, 1, 256,
   512) and training forward and backward (128, 1, 256, 512) in bf16 and
   the VAE's backward (32, 1, 1024, 512) in fp32 beside the plain version
   and SDPA (the backend its dispatcher picks). Then the CondUNet of
   ``configs/cifar10_sfron.yml`` at ``model.ch: 256`` (154,400,515
   parameters; six attention sites of width 512, five at T = 256 and the
   mid site at T = 16): a forward and a backward at batch 8 with the
   kernels against its plain path (phases 4 and 7's gates), every site on
   the bf16 ``xwide`` route (12 forward and 6 backward launches, none on
   the TMA kernels); and a VAE encode's gradient at 256 px (its mid
   attention's backward on the float32 ``xwide`` route, one launch)
   against its plain path (1e-4).
20. Stable Diffusion (the CompVis v1 UNet, 859,520,964 parameters, bf16,
   remat on; CLIP ViT-L/14's text tower, fp32; phase 19's VAE at 512 px;
   seeded init). (a) The bf16 attention kernels at the UNet's three
   self-attention shapes, (4, 8, T, D) at (4096, 40), (1024, 80) and (256,
   160), on CrossAttention's layout (views of the q, k, v projections):
   forward with and without its log-sum-exp, the log-sum-exp, backward,
   against the plain versions, three runs with equal bits, the same bits
   on contiguous copies, timed beside bf16 SDPA and the bound; GroupNorm
   forward and backward at the UNet's 14 bf16 site shapes at batch 4 (the
   route of each printed), as phase 3 and 6 time them, three runs with
   equal bits, and the backward's ``split`` sites (33 of 61 a backward)
   summed on a line of their own beside ``F.group_norm``'s backward, the
   bound and the two-read floor; the backward's ``split`` route at SD's
   nine shapes at batches 1 and 2 against the plain version, three runs
   with equal bits, and two calls captured in one CUDA graph giving the
   eager bits. (b) The
   whole UNet at batch 4 (64 x 64 x 4 latents, a 77 x 768 context),
   kernels against its plain path: the forward and the eps loss's
   gradients under full and ``"dots"`` remat, exact launch counts, peak
   memory. (c) One Fisher batch on the host clock and its device time by
   kernel family; ``sd_generate_fisher`` in this process on two seeded PNG
   folders of 8 images at 512 px, 1 of its 50 batches a folder, threshold
   0.5: exact launch counts, its three files, the Fishers finite,
   non-negative and not all zero, the mask's sparsity. (d) ``make_sampler``
   with ddim, plms and lms at 4 of 50 steps on 4 prompts (CFG batch 8),
   decoded by the VAE: exact launch counts, finite images, images/s.
21. Stable Diffusion's unlearning methods, on phase 20's PNG folders and
   Fisher folder. (a) ``generate_fisher_mask`` in this process on the
   Fisher folder (the SD layout): its ``nude_mask_0.5`` bit-equal to the
   mask ``sd_generate_fisher`` wrote. (b) ``sd_runner.nsfw_removal`` on the
   full-width UNet at batch 4 + 4, train_method full, under that mask dense
   and packed: 2 warm-up steps (the dense run's third step profiled: device
   ms by kernel family), then 2 counted steps, each on the host clock,
   with exact launch counts (a step: the forget phase's trained forward,
   its pseudo target's ``no_grad`` forward and the remain phase's trained
   forward, each trained one run again in the remat'd backward); losses
   and weights finite, peak memory. One step under xattn: every parameter
   outside the attn2 projections the same bits, Adam state for those only.
   (c) One full-width ``make_prox_operator`` call timed. The five method
   CLIs in this process with ``--device cuda`` and exact launch counts:
   ``nsfw_removal`` under the mask, packed, 2 steps with a snapshot at the
   last (``step_1.pt``, a CompVis checkpoint, and ``step_1_diffusers.npz``,
   whose keys are diffusers' and whose values are the snapshot's through
   the two key maps), then from its ``final.pt`` ``train_esd`` (2 steps,
   xattn, DDIM-10: its launches from the ``t_enc`` it drew; nothing
   outside attn2 moves), ``gradient_ascent``, ``proximal_gradient`` and
   ``random_label`` (1 step each): every ``final.pt`` holds the CompVis
   keys, finite, moved from its start. (d) The ``*_sd`` rows of the
   kernels line count these runs' launches too.
22. Stable Diffusion's evaluation, from phase 21's ``nsfw_removal``
   ``final.pt`` (unlearn, then evaluate), each CLI in this process with
   the launch counters zeroed just before and read just after. (a)
   ``generate_images`` on a prompt CSV of 4 cases (cases 2 and 3 share
   prompt and seed), 2 images a case at 512 px: lms at the CLI's settings
   (50 steps, CFG 7.5) on the last case, then ddim and plms at 4 steps on
   cases 1-3 (``--from_case 1``): exact launches (15 attention and 61
   GroupNorm a UNet forward, PLMS one forward more; 30 GroupNorm and one
   float32 ``xwide`` attention a decode), the PNG files and none for case
   0, cases 2 and 3 byte-equal, no image constant, case 1's ddim PNGs bit-
   equal to ``make_sampler`` + ``decode`` + truncation from its seed here,
   the decode of 2 latents timed; seconds and images/s beside the set-up's
   seconds. (b) ``imageclassify`` on the ddim folder with a seeded,
   perturbed ResNet50 saved as a ``.pth``: its rows the argsort of this
   phase's logits on the card. (c) ``nudenet_classes`` with an ``.npz`` of
   recorded YOLOv8n heads (1, 22, 2100) whose boxes map back to known
   pixels (letterbox scale 0.625, no pad): the CSV holds exactly the
   planted classes above ``--threshold``. (d) ``compute_fid`` between
   phase 20's two PNG folders (``--class_to_forget`` dropping ``nsfw``)
   and the ddim folder: finite, non-negative; the feature seconds on the
   card apart from the Fréchet seconds on the host. (e) The kernels line
   counts these launches: the SD rows' UNet and decode launches, the
   VAE's ``xwide`` row every SD encode's and decode's.

23. Data parallel and FSDP on ``torch.distributed`` (``uurg_torch/
   parallel``) on a one-rank NCCL group, each run against the one-device
   run of the same weights, seed and batches: ``sfron_forget`` on phase
   8's config (2 steps at 128 + 128, packed mask; under a group the DDPM
   runner splits every batch over the ranks with no flag), one DDIM-50
   batch of 128 through ``sample_images``, ``dit_forget`` on phase 18's
   seeded, perturbed DiT-XL/2 with ``mesh=data=1,model=1`` and
   ``parallelism="fsdp"`` (FSDP2 over the blocks, 2 steps at 32 + 32, a
   dense mask sharded like the parameters), ``nsfw_removal`` on phase
   20's seeded UNet the same way (2 steps at 4 + 4, a packed mask). Each
   prints the largest parameter difference and the relative L2 (gate
   1e-6: one rank changes no arithmetic), the four kernels' launches
   (equal to the one-device run's), the call's ms and peak memory.

24. Tensor parallel (``uurg_torch/parallel/{mesh,tensor}.py``) on the same
   one-rank group and ``mesh=data=1,model=1``: ``dit_forget`` and
   ``nsfw_removal`` under ``parallelism="tp"`` (DIT_TP_RULES; SD_TP_RULES
   with FSDP over the same axis for the rest), each against phase 23's
   one-device run (reused, not rerun). It fails unless the rules placed
   every qkv (3 pieces), adaLN (6), GEGLU (2) and other projection they
   name, and gates each run as phase 23 does (relative L2 1e-6, launches
   equal), with the call's ms and peak memory (unprofiled: phase 23
   profiles DiT's step and phase 21 SD's).

25. Ring attention and the DiT pipeline (``uurg_torch/parallel/
   {sequence,pipeline}.py``) on the same one-rank group. (a) The ring's
   arithmetic over 2 and 4 ranks in this process
   (``ring_attention_loopback``: the ranks stacked along the batch, S
   forward and S backward kernel calls) at DiT-XL/2's (32, 16, 256, 72)
   on MHSA's views and SD's (4, 8, 4096, 40) in bf16, and DiT's (2, 16,
   256, 72) in float32, against ``attention_plain`` and its autograd at
   phases 18's and 20's gates, with exact launches, timed beside one
   whole kernel call. (b) ``dit_forget`` under ``sp`` on data=1,seq=1 and
   under ``pp`` on stage=1 in 1 and 2 microbatches, (c) ``nsfw_removal``
   under ``sp`` on seq=1, each against phase 23's one-device run: one
   rank in one microbatch gated as phase 23 (relative L2 1e-6, launches
   equal); 2 microbatches by the update's relative L2 (PP_UPDATE_REL) and
   twice the attention launches; each with the call's ms and peak memory
   (unprofiled).

Each phase's heading carries the seconds since the start. Prints the
kernels JSON line and the card's name and power limit, then as the last
line ``{"ok": true, "device": {...}}``. Per-shape details go to
``chiprun_out/chip_smoke_detail.json``. Exits non-zero without CUDA or
outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STARTED = time.time()

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 rate, bf16
# tensor-core rate, fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
TF32_TC_FLOPS = 495e12
FP32_FLOPS = 67e12

SAMPLING_BATCH = 128     # configs/cifar10_sfron.yml sampling.batch_size
TRAIN_BATCH = 128        # configs/cifar10_sfron.yml training.batch_size
DDIM_STEPS = 50
COND_SCALE = 2.0
SEED = 0
WARMUP_STEPS, TRAIN_STEPS = 2, 10
FORGET_ALPHA = 10.0      # cli/train.py --forget_alpha default

# the DDPM paths' configs, read by the port's own YAML reader (the card's
# machine has no PyYAML)
SFRON_YML = os.path.join(ROOT, "configs", "cifar10_sfron.yml")
SA_YML = os.path.join(ROOT, "configs", "cifar10_sa.yml")


def sfron_config():
    """configs/cifar10_sfron.yml as the CLIs load it (a fresh Config: the
    phases cut their copies)."""
    from uurg_torch.core.config import load_config

    return load_config(SFRON_YML)


def sa_config():
    """configs/cifar10_sa.yml, the Selective Amnesia sections."""
    from uurg_torch.core.config import load_config

    return load_config(SA_YML)


# kernel tolerances against the plain version in bf16:
# |kernel - plain| <= ATOL + RTOL * |plain|. Both round their output to bf16
# (relative step 2**-8 = 0.0039) after fp32 arithmetic summed in another
# order, and the attention kernel rounds unnormalised probabilities to bf16
# where the plain version rounds normalised ones; 1e-2 covers one to two
# output roundings.
ATOL, RTOL = 1e-2, 1e-2
# whole-model check at batch 8 (kernels vs plain path, both bf16): relative
# L2 error of the eps output. bf16 roundings at ~150 layers compound.
MODEL_REL_L2 = 2e-2
# backward kernels vs plain versions in bf16, relative L2 error per output:
# dk and dv are sums over T (dq over the keys), so an elementwise bound
# would fail on entries that cancel. Both sides round P and dS to bf16
# before the products and round each gradient once (2**-8 each); the kernel
# takes delta from the bf16 forward output where the plain version sums
# P * dP in fp32.
BWD_REL_L2 = 2e-2
# GroupNorm's dscale and dbias: fp32 sums over batch and space of the same
# fp32 products in another order (up to 131072 terms)
GN_SUM_REL_L2 = 1e-4
# whole-model gradients at batch 8, kernels vs plain path, both bf16,
# relative L2 of all parameter gradients concatenated (not per leaf: the
# leaves whose exact gradient is zero hold only rounding noise). The forward
# alone differs at ~1.1e-2 (phase 4); the backward runs a second chain of
# bf16 roundings of the same depth.
MODEL_GRAD_REL_L2 = 5e-2
# the forward's log-sum-exp (fp32) against torch.logsumexp of fp32 scores:
# both sum exp in fp32, in another order
LSE_ATOL = 1e-4
# CUgraphNodeType (cuda.h) of a kernel node
GRAPH_KERNEL_NODE = 0
# (T, D) off the main path, at batch 4 x 2 heads: T below, across and far
# above one tile, not a multiple of 8; D not a multiple of 64 (the bf16
# kernels read it at its true width, with a narrow last chunk; the fp32
# wrapper pads it to 64, 128, 192) and a multiple
RAGGED_SHAPES = ((16, 72), (77, 40), (100, 72), (130, 160), (256, 192),
                 (1024, 64), (1024, 256))
RAGGED_REPEATS = 3
# the float32 attention kernels (phase 16): (B, H, T, D) of ViT-B/16 at
# 224 px (batch 64, the phase-17 SFR-on batch; the tiled route) and at
# main_random's 32 px (batch 256, 5 tokens; the packed route), then head
# widths the wrapper pads (40 -> 64, 160 -> 192: the wide route), then the
# edges of the packed and tiled routes (ops/flash_attention.py, _f32_plan):
# T within one packed warp, the packing bound 16 and one past it, one past
# and short of a 16-row group, a 32-query tile and a 64-key tile, and ViT's
# T with its neighbours, at D = 64 and padded from 40 (batch 4 x 3 heads:
# 12 heads, so packed chunks are ragged at the end); RAGGED_SHAPES follow
# at batch 4 x 2 heads. Every shape runs three times with equal bits.
F32_VIT_SHAPE = (64, 12, 197, 64)
VIT_BLOCKS = 12          # attention launches per ViT-B/16 forward
F32_EDGE_T = (5, 16, 17, 31, 33, 63, 65, 196, 197, 208)
F32_SHAPES = ((F32_VIT_SHAPE, (256, 12, 5, 64), (8, 12, 197, 40),
               (8, 12, 197, 160))
              + tuple((4, 3, T, D) for T in F32_EDGE_T for D in (64, 40)))
# float32 kernel vs plain version, both float32 (TF32 off), relative L2:
# the kernel sums the D-term scores, the softmax and the T-term products in
# another order and in base 2 (the scale folded with log2 e), so each output
# carries ~sqrt(T) float32 roundings (~1e-6); the backward's
# dS = P (dP - delta) cancels where dP is close to delta, and dk, dv sum T
# such terms, so it gets ten times the forward's room
F32_FWD_REL, F32_BWD_REL = 1e-5, 1e-4
# GroupNorm forward off the main path: (batch, H = W, C, dtype name)
GN_OFFPATH_SHAPES = ((3, 4, 256, "float32"), (3, 32, 384, "float32"),
                     (3, 5, 256, "bfloat16"), (3, 12, 384, "bfloat16"),
                     (3, 32, 512, "float32"), (1, 16, 256, "bfloat16"),
                     (3, 8, 24, "bfloat16"), (3, 8, 24, "float32"),
                     (1, 1, 64, "bfloat16"), (3, 21, 384, "bfloat16"),
                     (2, 29, 640, "bfloat16"))
# fp32 in and out: only the order of the fp32 sums differs from the plain
# version's (y), and the statistics are fp32 at either dtype
GN_FP32_ATOL, GN_FP32_RTOL = 1e-5, 1e-5
GN_RSTD_TOL = 1e-4
# GroupNorm backward off the main path: (batch, H = W, C, dtype name); the
# main path's eleven shapes at batch 256 follow
GN_BWD_OFFPATH_SHAPES = ((3, 5, 128, "bfloat16"), (3, 5, 128, "float32"),
                         (3, 12, 384, "bfloat16"), (3, 12, 384, "float32"),
                         (3, 8, 24, "bfloat16"), (3, 8, 24, "float32"),
                         (1, 1, 64, "bfloat16"), (1, 16, 256, "bfloat16"),
                         (3, 32, 384, "float32"), (3, 21, 384, "bfloat16"),
                         (40, 16, 128, "float32"))
# (H = W, C, sites in one pass) of the GroupNorm sites of the full-width
# CIFAR-10 CondUNet: the profile scripts' shapes
GN_SITES = ((32, 128, 8), (16, 256, 11), (32, 256, 2), (4, 256, 12),
            (32, 384, 1), (16, 512, 2), (8, 256, 7), (16, 384, 1), (4, 512, 3),
            (8, 512, 3), (16, 128, 1))
# fp32 dx: the same fp32 products in another order, then gs - s1 - x_hat s2,
# which cancels where the three are close
GN_BWD_FP32_TOL = 1e-4
# the Fisher pass (configs/cifar10_fisher.yml differs from the sfron config
# in no value the pass reads): CFG 2.0 double forward of each batch of 128
# of the forget and remain splits, the ragged last batch kept. On the
# stand-in (2048 samples) the splits hold 190 and 1858: 17 batches, of CFG
# batch 256 but for the last of each split (124 and 132)
FISHER_BATCHES = (2 * TRAIN_BATCH, 124, 132)
FISHER_THRESHOLDS = (0.5, 1.0, 2.0)
SALUN_RATIO = 0.5
MASKED_STEPS = 2
# one Fisher batch, kernels vs plain path: relative L2 of the squared
# gradients concatenated; a square doubles the gradient's relative error
FISHER_REL_L2 = 2 * MODEL_GRAD_REL_L2
# Selective Amnesia (sa_config()): the SA Fisher at cli/fim.py's
# --n_chunks default, n_samples cut from 256 to 4 (batch 4): 80 examples,
# each a forward and a backward at batch T / FIM_CHUNKS = 50
FIM_CHUNKS, FIM_SAMPLES, FIM_BATCH = 20, 4, 4
SA_WARMUP_STEPS, SA_STEPS = 2, 5
# evaluation and the twin of cli/parity_check.py (phase 14). The networks on
# the card against the same weights on the CPU, fp32 with TF32 off: relative
# error of the max magnitude (cuDNN and the CPU sum the convolutions in
# other orders)
EVAL_REL = 1e-3
EVAL_CHECK_BATCH = 4
INCEPTION_BATCH, INCEPTION_IMAGES = 256, 2048
PROBE_BATCH, PROBE_IMAGES = 64, 512
# the twin's cuts of the full north-star run: SFR-on 2 of 150 iterations,
# one sample a remaining class (9 of 45,000; the nine classes must divide
# it), 16 probe samples of 5,000; DDIM-50 and the references (the
# stand-in's remain split) uncut (the pipeline phase runs the same stages
# through the CLIs)
PARITY_ITERS, PARITY_SAMPLES, PARITY_PROBE = 2, 9, 16
# the north-star pipeline through the port's CLIs (README.md's commands),
# each in a process of its own, at configs/cifar10_sfron.yml's full width on
# the stand-in data: pretrain PIPE_ITERS iterations (of 800,000),
# generate_fisher at threshold 1.0 (one pass of the splits, uncut), sfron
# PIPE_ITERS (of 150), sample_fid PIPE_SAMPLES a class (of 500) of the nine
# kept classes, DDIM-50; the evaluator on the random-init InceptionV3 against
# save_base_dataset's references; classifier_evaluation with a probe that
# train_classifier trains for PIPE_PROBE_STEPS steps at 32 px
PIPE_ITERS, PIPE_SAMPLES = 2, 8
PIPE_PROBE_BATCH, PIPE_PROBE_RES = 1024, 32
PIPE_TIMEOUT = 300
# the evaluator's and classifier_evaluation's host threads: they run on
# beside the script's next phases, which keep the other cores
EVAL_THREADS = 2
# classification (phase 15): ResNet-18 with the CIFAR stem at full width on
# a CIFAR-10-sized stand-in (50,000 train and 10,000 test images of 32 px,
# 10 classes, noise 0.5), random 10% forgetting (5,000 forget, 45,000
# retain), batch 256. The card against the CPU in fp32 (TF32 off) at batch
# 16: relative L2 (the convolutions sum in other orders)
CLS_TRAIN, CLS_TEST, CLS_BATCH, CLS_CHECK_BATCH = 50_000, 10_000, 256, 16
CLS_REL = 1e-4
# the fp32 gradients: the backward of 20 train-mode BatchNorms subtracts
# the gradient's projections on 1 and on x_hat, which cancels, so the
# rounding of each side's fp32 sums grows to ~1e-3 at the first layers
# (each side's distance from float64 is printed beside it)
CLS_GRAD_REL = 5e-3
# float64 on both: only the order of the sums differs
CLS_F64_REL = 1e-9
# SFR-on cut from 1,500 iterations to 10 warm-up (5 of them profiled) + 50
# timed, through the method's n_iters override; the other eight methods at
# one epoch each (Finetune, RandomLabel, SalUn, BadTeacher from 10 epochs,
# Retrain from 200, GradAscent from 9, SCRUB from 6 epochs and 2 max steps)
CLS_WARMUP, CLS_PROFILED, CLS_TIMED = 10, 5, 50
# SFRon's chunked path (make_sfron_scan, one CUDA graph replay a chunk):
# chunk 0 the eager warm-up, chunk 1 the first replay (after its capture)
# held against the plain chunk loop from the same state and seed, chunk 2
# under the profiler, the rest timed on the host clock. ResNet-18 bf16 at
# the method's default scan_chunk (50) over CLS_SCAN_ITERS iterations; fp32
# CLS_F32_ITERS iterations in chunks of CLS_F32_CHUNK (the warm-up and the
# compared replay); the per-step path (scan_chunk 1) at bf16 beside it,
# CLS_WARMUP + CLS_TIMED iterations
CLS_SCAN_CHUNK, CLS_SCAN_ITERS = 50, 250
CLS_F32_CHUNK, CLS_F32_ITERS = 5, 10
SCAN_COMPARED, SCAN_PROFILED = 1, 2
# graph against plain loop: equal bits expected (the same kernels on the
# same inputs in the same order); where the plain loop's own run-to-run
# spread is not 0 (a kernel that sums with atomics), within SCAN_SPREAD
# times that spread, measured by running the plain loop twice
SCAN_SPREAD = 4
CLS_ONE_EPOCH = {"epochs": 1, "sgda_epochs": 1, "msteps": 1}
# the eight methods' epoch runs over every CLS_METHODS_EVERY-th image of the
# retain and forget splits (4,500 + 500): depth cut to keep the script in
# its call's time, at the same batch and model
CLS_METHODS_EVERY = 10
# ViT-B/16 and Swin-T classification (phase 17) at 224 px: the card against
# the CPU at batch 2 from the same weights, fp32 (TF32 off), relative L2 of
# the logits and of all parameter gradients (no BatchNorm here, but twelve
# LayerNorm backwards and the attention backward's cancellations: each
# side's distance from float64 is printed beside it). On an H100 the
# logits read 8.5e-7 and the gradients 1.1e-6 (ViT_B; Swin_T 1.7e-7 and
# 3.3e-7): the gradient limit sits ten times above the higher reading, low
# enough that a TF32 product (~1e-3) in the backward would fail it
VIT_RES, VIT_CHECK_BATCH = 224, 2
VIT_REL, VIT_GRAD_REL = 1e-4, 1e-5
# SFR-on through the registry at batch 64 on a 224 px stand-in (320 train
# images, random 10% forgetting: 32 forget, 288 retain), cut from 1,500
# iterations to VIT_WARMUP (one profiled) + VIT_TIMED; Swin-T runs
# SWIN_ITERS iterations without the Fisher mask
VIT_BATCH, VIT_TRAIN = 64, 320
VIT_WARMUP, VIT_TIMED, SWIN_ITERS = 3, 10, 3
# ViT-B/16's chunked path: VIT_SCAN_ITERS iterations in chunks of
# VIT_SCAN_CHUNK (a multiple of forget_freq 5: one graph), chunks as
# CLS_SCAN_*'s; the per-step path (scan_chunk 1) at VIT_WARMUP + VIT_TIMED
VIT_SCAN_CHUNK, VIT_SCAN_ITERS = 5, 25
# main_random's SFRon in the CLI runs, cut from its 1,500 iterations
# through the method's n_iters override (sfron_cut): the ResNet-18 run
# of phase 15 to 250 (where it logs its rate), the ViT-B/16 run of phase 17
# to 10
CLS_CLI_ITERS, VIT_CLI_ITERS = 250, 10
# the SVC attack's fit timed at SVC_N + SVC_N (cut from the protocol's cap
# of 4,000 + 4,000: the SMO's time grows with the square)
SVC_N = 2000
# the remat'd DDPM step (after phase 17): the full-width config at batch 128
# in train mode (dropout on), remat against no remat from the same weights
# and generator. The loss must be equal. The recompute runs the same
# kernels on the same inputs, so the gradients may differ from the plain
# step's by no more than REMAT_SPREAD times the plain step's own run-to-run
# spread, measured beside it by running the plain step twice: bit-equality
# where that spread is 0, as both readings were on an H100
REMAT_SPREAD = 4
REMAT_STEPS = 4
# DiT-XL/2 class forgetting (phase 18): 32x32x4 latents, patch 2 (T = 256
# tokens), hidden 1152 in 16 heads of width 72 (read at that width, as
# views of the fused projection, by the bf16 attention kernels), 28 blocks. The attention kernels at the training
# batch (DiT/forget.py's 32; the CFG sample grid's 2 x 16 is the same
# shape), and the float32 pair at the 4-block card-vs-CPU check's batch 2
DIT_NAME, DIT_BLOCKS, DIT_BATCH = "DiT-XL/2", 28, 32
DIT_ATTN_SHAPE = (DIT_BATCH, 16, 256, 72)
DIT_F32_SHAPE = (2, 16, 256, 72)
DIT_CHECK_BATCH = 4
# the whole DiT-XL/2 in fp32 (TF32 off) would not fit a CPU check's time,
# so four blocks at full width, card against CPU at batch 2. On an H100 the
# output read 1.6e-6 and the gradients 3.2e-6 (each side 1.4e-6 to 3.2e-6
# from float64): the gates sit six and nine times above, low enough that a
# TF32 product (~1e-3) would fail them
DIT_F32_BLOCKS, DIT_F32_BATCH = 4, 2
DIT_REL, DIT_GRAD_REL = 1e-5, 3e-5
# the stand-in: 2,048 seeded latents over 10 of the 1,000 classes (class 0
# ~ 200), 4 shards, and the seeded DiT-XL/2 perturbed (so its gates are
# open and its Fisher and mask mean something) as a reference .pt that the
# CLIs read with --ckpt; the CLIs cut (dit_generate_fisher 4 of 2,000
# batches, forget 3 of 600 steps: one snapshot and one checkpoint round,
# 21.6 GB written); the timed run 2 warm-up + 1 profiled, then 5 counted
# steps under each remat policy; the sample grid DiT's 50 respaced steps,
# CFG 4.0, 16 labels
DIT_LATENTS, DIT_SHARDS, DIT_STANDIN_CLASSES = 2048, 4, 10
DIT_FISHER_ITERS, DIT_CLI_ITERS = 2, 3
DIT_WARMUP, DIT_STEPS = 2, 2
DIT_GRID_STEPS, DIT_COND_SCALE, DIT_GRID_CLASSES = 50, 4.0, 8
# the frozen VAE (phase 19): VAEConfig(), the CompVis first stage DiT uses
# (sd-vae-ft-ema), 83,653,863 parameters, fp32 (TF32 off), seeded init, at
# 256 px (32 x 32 x 4 latents) and batch 32; its two mid-block attentions
# are one head of width 512 at T = 1024 (the float32 xwide route), and it
# runs 22 GroupNorm forwards an encode and 30 a decode
VAE_RES, VAE_BATCH = 256, 32
VAE_ATTN_SHAPE = (VAE_BATCH, 1, 1024, 512)
VAE_GN_ENCODE, VAE_GN_DECODE = 22, 30
# the width-512 forward off the main path at batch 2 x 1 head: T below one
# 64-key tile, ragged, the VAE's and SD's (512 px), at D = 512 and at 320
# (300 zero-padded to 320)
XWIDE_SHAPES = tuple((T, D) for T in (16, 100, 1024, 4096)
                     for D in (512, 320, 300))
# timed: the VAE's shape, and SD's VAE at 512 px (T = 4096) at batch 2
XWIDE_TIMED = (VAE_ATTN_SHAPE, (2, 1, 4096, 512))
# the xwide kernels in both dtypes and their backward (the width phase): the
# padded widths 320-512 at batch 2 x 1 head, a ragged T, a T that every
# tile divides and the mid site's T = 16; then timed: the wide CondUNet's
# (model.ch 256: one head of 512 at 16 x 16) CFG forward and training
# forward and backward in bf16, and the VAE's backward in fp32
XW_WIDTHS = (320, 384, 448, 512)
XW_TS = (100, 256, 16)
XW_UNET_CFG = (256, 1, 256, 512)
XW_UNET_TRAIN = (128, 1, 256, 512)
# the CondUNet of configs/cifar10_sfron.yml at model.ch 256 (parameters
# counted on the CPU): six attention sites of width 512, five at 16 x 16 and
# the mid site at 4 x 4
WIDE_CH, WIDE_PARAMS, WIDE_SITES = 256, 154_400_515, ((256, 5), (16, 1))
# SD's bf16 UNet GroupNorm sites that fit no cluster (H, W, C), off the
# path, at nsfw_removal's batch 4
SD_GN_SITES, SD_GN_BATCH = ((64, 64, 320), (64, 64, 640), (64, 64, 960),
                            (32, 32, 1280), (32, 32, 1920)), 4
# the full VAE in fp32, card against CPU at batch 1 (TF32 off on both):
# the convolutions and GroupNorm sums in other orders through ~60 layers
VAE_REL = 1e-4
# the entry points: a seeded PNG folder of VAE_PNG_CLASSES classes x
# VAE_PNG_EACH images (Pillow is on the card's machine), encoded by
# encode_latents into shards of VAE_BATCH; forget cut from 600 steps to one
# at batch VAE_FORGET_BATCH (a class holds VAE_PNG_EACH images) from the
# shards and from the folder; dit_sample --mode fid_npz with 64 labels in
# batches of 32 at VAE_SAMPLE_STEPS respaced steps (cut from 250), CFG 4.0
VAE_PNG_CLASSES, VAE_PNG_EACH = 4, 16
VAE_FORGET_BATCH = 16
VAE_FID_SAMPLES, VAE_SAMPLE_STEPS = 64, 4
# Stable Diffusion (phase 20): the CompVis v1 UNet
# (configs/stable-diffusion/v1-inference.yaml: ch 320, mult 1-2-4-4, 2 res
# blocks, attention at ds 1, 2 and 4, 8 heads, context 768; 859,520,964
# parameters) in bf16 with remat on, at 512 px (64 x 64 x 4 latents), seeded
# init; CLIP ViT-L/14's text tower (123,060,480 parameters, fp32) on the
# tokenizer tier the machine has (the crc32 stand-in without vocab files);
# phase 19's VAE at 512 px. A forward runs the attention kernels at its 15
# self-attention sites of T % 128 == 0 (T = 4096, 1024, 256 at D = 40, 80,
# 160) and GroupNorm at 61 sites. SD_BATCH is generate_fisher's and
# nsfw_removal's batch; the Fisher CLI cut from 50 batches to
# SD_FISHER_BATCHES over SD_PNG_EACH seeded PNGs a folder; the samplers cut
# from 50 steps to SD_SAMPLE_STEPS on SD_PROMPTS prompts (CFG batch 8)
SD_BATCH, SD_LATENT, SD_HEADS, SD_CONTEXT = 4, 64, 8, (77, 768)
SD_RES = 8 * SD_LATENT
SD_ATTN_SITES, SD_UNET_GN_SITES = 15, 61
# (H, W, C, sites a backward) of the SD UNet's GroupNorm backward sites that
# no cluster holds: the split route, 33 of the 61 sites
SD_BWD_SPLIT_SITES = ((64, 64, 320, 13), (32, 32, 640, 11), (64, 64, 640, 2),
                      (32, 32, 960, 1), (64, 64, 960, 1), (32, 32, 1280, 1),
                      (16, 16, 1920, 1), (32, 32, 1920, 1), (16, 16, 2560, 2))
SD_PNG_EACH, SD_FISHER_BATCHES, SD_THRESHOLD = 8, 1, 0.5
SD_GUIDANCE, SD_FISHER_GUIDANCE = 7.5, 3.0
SD_SAMPLE_STEPS, SD_PROMPTS = 4, 4
# UNet forwards a sampler makes at SD_SAMPLE_STEPS (PLMS: one more, its
# warm-up's second call)
SD_SAMPLER_FORWARDS = {"ddim": SD_SAMPLE_STEPS, "plms": SD_SAMPLE_STEPS + 1,
                       "lms": SD_SAMPLE_STEPS}
# device time of a Fisher batch by kernel family: the first match wins, on
# the lower-cased kernel name
SD_FAMILIES = (
    ("attention", ("attn_",)),
    ("GroupNorm", ("gn_",)),
    ("GEMM / conv", ("gemm", "cutlass", "cudnn", "xmma", "sm90_", "nvjet",
                     "conv", "fprop", "dgrad", "wgrad", "implicit")),
    ("casts", ("copy", "cast")),
    ("elementwise", ("",)),
)


# SD's unlearning methods (phase 21) on phase 20's model, PNG folders and
# Fishers: the SFR-on step of nsfw_removal at SD_BATCH + SD_BATCH (of its
# 1,000 steps, SD_SFRON_WARMUP warm-up and one profiled, then
# SD_SFRON_TIMED counted) under the Fisher mask dense and packed, one step
# under train_method xattn; the five CLIs in process at SD_CLI_ITERS of
# their 1,000 steps (nsfw_removal snapshots at its last; the three
# baselines at SD_BASELINE_ITERS), ESD's partial
# denoise cut from 50 DDIM steps to SD_ESD_DDIM (a divisor of the 1,000
# training steps, as LDM's DDIM grid needs); the prox at the CLI's top
# ratio
SD_SFRON_WARMUP, SD_SFRON_TIMED, SD_CLI_ITERS = 2, 1, 2
SD_BASELINE_ITERS = 1          # gradient ascent, proximal, random label
SD_ESD_DDIM, SD_TOP_RATIO = 10, 0.01

# SD's evaluation (phase 22) on phase 21's nsfw_removal final.pt, through
# the four CLIs in this process: generate_images at its own settings (lms,
# SD_EVAL_LMS_STEPS steps, CFG SD_GUIDANCE, SD_RES px) on the last case,
# then ddim and plms at SD_SAMPLE_STEPS steps on cases 1-3 (--from_case
# 1), SD_EVAL_SAMPLES images a case; cases 2 and 3 share prompt and seed.
# imageclassify with a seeded, perturbed ResNet50 (CIFAR stem, 10 classes)
# on the ddim folder; nudenet_classes on recorded YOLOv8n heads at 320 px
# (4 + 18 classes, 40^2 + 20^2 + 10^2 anchors); compute_fid between phase
# 20's two PNG folders (one class dropped) and the ddim folder
SD_EVAL_SAMPLES, SD_EVAL_LMS_STEPS = 2, 50
SD_EVAL_PROMPTS = (
    "case_number,prompt,evaluation_seed\n"
    '0,"a photo of a nude person, on a beach",11\n'
    "1,a photo of a person wearing clothes,12\n"
    '2,"a church, at night",13\n'
    '3,"a church, at night",13\n')
NUDENET_SIZE, NUDENET_ANCHORS, NUDENET_THRESHOLD = 320, 2100, 0.6

# data parallel and FSDP (phase 23) on one NCCL rank: NCCL takes no two
# ranks on one device, so the card runs world size 1 (the multi-rank runs
# are the CPU tests' on gloo). Each run against the one-device run of the
# same weights, seed and batches: the DDPM SFR-on step (auto data
# parallel) and one DDIM batch of sample_images; dit_forget under fsdp at
# 32 + 32 with a dense mask; nsfw_removal under fsdp at 4 + 4 with a packed
# mask. One rank changes no arithmetic: bit-equal expected, gated at
# relative L2 DP_REL, launch counts equal. DiT's and SD's last step runs
# under the profiler (device ms by kernel family, one device against
# FSDP); DP_DRAW_RANKS: the data-parallel width at which each rank's
# global draws (t, noise, keep and dropout masks for the whole batch) are
# timed, on the CondUNet at TRAIN_BATCH rows a rank
DP_DDPM_STEPS, DP_DIT_STEPS, DP_SD_STEPS, DP_REL = 2, 2, 2, 1e-6
DP_DRAW_RANKS = 8
# ring attention and the DiT pipeline (phase 25) on the same one-rank NCCL
# group. (a) The ring's arithmetic fed RING_SEQS chunks in one process
# (the loopback: the ranks stacked along the batch, S forward and S
# backward kernel calls) at DiT-XL/2's attention shape on MHSA's views and
# SD's at RING_SD_SHAPE on CrossAttention's, held to the plain attention
# and its autograd at the gates of phases 18 and 20 (ATOL/RTOL forward,
# BWD_REL_L2 backward), and at DIT_F32_SHAPE in float32 (the float32
# kernels, F32_FWD_REL / F32_BWD_REL). (b) dit_forget under sp (data=1,seq=1) and pp
# (stage=1) in 1 and PP_MICROBATCHES microbatches, (c) nsfw_removal under
# sp (seq=1), each against phase 23's one-device run: one rank in one
# microbatch at DP_REL with equal launches; PP_MICROBATCHES microbatches
# change the rows of every GEMM, and Adam turns the reordered bf16 sums
# of gradients near zero into moves of either sign: the parameters'
# update (after - start) within PP_UPDATE_REL relative L2 of one device's
# (tests/test_torch_parallel_pp.py's bf16 run of a depth-4 DiT over
# DP_DIT_STEPS steps reads 0.039, the same update with one of its four
# blocks left unchanged 0.48),
# launches PP_MICROBATCHES times one device's
RING_SEQS = (2, 4)
RING_SD_SHAPE = (4, 8, 4096, 40)
PP_MICROBATCHES, PP_UPDATE_REL = 2, 0.1


# (seconds since the start, heading) of each phase, for the detail file
PHASE_STARTS = []


def banner(msg: str) -> None:
    """A phase's heading, with the seconds since the script started."""
    PHASE_STARTS.append((round(time.time() - STARTED, 1), msg[:100]))
    print(f"== {msg} [at {time.time() - STARTED:.1f} s]", flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def sh(cmd: list[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (out.stdout or out.stderr).strip()


def card_line() -> str:
    return sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])


def _events_ms(run, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int = 20, stream=None) -> tuple[float, float]:
    """(device ms, eager ms) per call of ``fn``, back to back on the same
    inputs. Device time replays the calls captured in a CUDA graph, so the
    host's launch cost is not in it; eager time launches from Python as the
    sampling path does, and exceeds the device time wherever a call's
    kernels finish faster than the host can launch them. ``stream`` is the
    capture stream: a library backward must be captured on the stream its
    forward ran on, where autograd replays it."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    device = _events_ms(graph.replay, iters)

    def eager():
        for _ in range(iters):
            fn()

    eager()
    return device, _events_ms(eager, iters)


def compare(name: str, got, want, atol: float = ATOL,
            rtol: float = RTOL) -> float:
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    max_abs = err.max().item()
    print(f"  {name}: max_abs_err {max_abs:.3e} "
          f"(tolerance {atol:g} + {rtol:g}*|plain|)", flush=True)
    if (err > atol + rtol * want.abs()).any():
        fail(f"{name}: kernel disagrees with its plain version")
    return max_abs


def collect_sites(model, device):
    """The (kind, shape) of every attention and GroupNorm call in one forward,
    read by hooks at batch 2 and scaled to the CFG batch later."""
    import torch

    from uurg_torch.models import layers

    sites = []
    hooks = []
    for m in model.modules():
        if isinstance(m, layers.GroupNorm32):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: sites.append(
                    ("gn", tuple(args[0].shape[1:]), mod.num_groups))))
        elif isinstance(m, layers.SelfAttention2D):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: sites.append(
                    ("attn", tuple(args[0].shape[1:]), 1))))
    x = torch.randn(2, 32, 32, 3, device=device)
    t = torch.tensor([10, 500], device=device)
    c = torch.tensor([1, 2], device=device)
    with torch.inference_mode():
        model(x, t, c, torch.tensor([True, False], device=device))
    for h in hooks:
        h.remove()
    return sites


def check_kernels(sites, batch: int, gen) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from uurg_torch.ops import group_norm as GN
    from uurg_torch.ops.flash_attention import attention, attention_plain
    from uurg_torch.ops.group_norm import group_norm, group_norm_plain

    dev = torch.device("cuda")
    rows = []
    shapes = sorted({(k, s, g) for k, s, g in sites})
    for kind, (C, H, W), groups in shapes:
        count = sum(1 for s in sites if s == (kind, (C, H, W), groups))
        extra = {}
        if kind == "attn":
            T, D = H * W, C
            q, k, v = (torch.randn(batch, 1, T, D, generator=gen, device=dev,
                                   dtype=torch.bfloat16) for _ in range(3))
            got = attention(q, k, v)
            torch.cuda.synchronize()
            max_abs = compare(f"attention B={batch} T={T} D={D}",
                              got, attention_plain(q, k, v))
            run = (lambda: attention(q, k, v),
                   lambda: attention_plain(q, k, v),
                   lambda: F.scaled_dot_product_attention(q, k, v))
            nbytes = 4 * batch * T * D * 2
            ops, peak = 4 * batch * T * T * D, BF16_TC_FLOPS
            shape = {"B": batch, "H": 1, "T": T, "D": D}
            name = "attention_fwd"
        else:
            x = (torch.randn(batch, H, W, C, generator=gen, device=dev) * 2
                 + 0.5).to(torch.bfloat16)
            scale = torch.randn(C, generator=gen, device=dev) * 0.2 + 1.0
            bias = torch.randn(C, generator=gen, device=dev) * 0.2
            route, cluster = GN._fwd_route(H * W, C, x.element_size(), groups,
                                           batch)
            got = group_norm(x, scale, bias, groups=groups)
            torch.cuda.synchronize()
            tag = f"B={batch} H={H} W={W} C={C}"
            want = group_norm_plain(x, scale, bias, groups, 1e-6)
            max_abs = compare(f"group_norm {tag} ({route}, cluster {cluster})",
                              got, want)

            runs = GN._split_count(batch, H * W, C, x.element_size())

            def split():
                return GN._group_norm_kernel(x, scale, bias, groups, 1e-6,
                                             route=("split", runs))

            compare(f"group_norm {tag} (split, {runs} runs)", split()[0],
                    want)
            extra = {"route": route, "cluster": cluster,
                     "split_ms": time_ms(split)[0]}
            x_nchw = x.permute(0, 3, 1, 2)
            s16, b16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
            run = (lambda: group_norm(x, scale, bias, groups=groups),
                   lambda: group_norm_plain(x, scale, bias, groups, 1e-6),
                   lambda: F.group_norm(x_nchw, groups, s16, b16, 1e-6))
            numel = batch * H * W * C
            nbytes = 2 * numel * 2 + 2 * C * 4 + 2 * batch * groups * 4
            ops, peak = 4 * numel, FP32_FLOPS
            shape = {"B": batch, "H": H, "W": W, "C": C, "G": groups}
            name = "group_norm_fwd"
        ms, eager_ms = time_ms(run[0])
        plain_ms, lib_ms = time_ms(run[1])[0], time_ms(run[2])[0]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / peak * 1e3
        rows.append({
            "name": name, "shape": shape, "sites_per_forward": count,
            "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": max_abs, **extra,
        })
        print(f"  {name} {shape} x{count}/forward: kernel {ms:.4f} ms "
              f"(eager {eager_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} "
              f"ms ({rows[-1]['bound_by']})"
              + (f"; {extra['route']} route, cluster {extra['cluster']}, "
                 f"split route {extra['split_ms']:.4f} ms" if extra else ""),
              flush=True)
    return rows


def summarise(rows: list[dict], launches: dict, meta: dict) -> list[dict]:
    """One entry per kernel. Times are per UNet pass (a forward at batch
    256 for the forward kernels, a backward at batch 128 for the backward
    kernels): the sum over the pass's sites of the per-launch time at that
    site's shape. ``launches`` counts the main paths' runs."""
    out = []
    for name, info in meta.items():
        mine = [r for r in rows if r["name"] == name]
        if not mine:
            fail(f"{name}: no site of the main paths reached it")

        def total(key):
            return sum(r[key] * r["sites_per_forward"] for r in mine)

        bytes_ms, ops_ms = total("bytes_ms"), total("ops_ms")
        out.append({
            "name": name, "route": "cuda", "source": info["source"],
            "replaces": info["replaces"],
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "eager_ms": total("eager_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": total("library_ms"),
            "per": info["per"] + ": sum over its sites of the device ms per "
                   "launch (CUDA-graph replay); eager_ms launches from Python",
        })
    return out


@contextlib.contextmanager
def plain_layers():
    """Route the models' attention and GroupNorm through their plain
    versions for the duration (the whole-model checks' reference): the
    UNet's layers, the transformers' ``uurg_torch.models.dit`` and SD's
    ``uurg_torch.models.sd_unet``, each of which imports ``attention`` by
    name."""
    from uurg_torch.models import dit, layers, sd_unet
    from uurg_torch.ops.flash_attention import attention_plain
    from uurg_torch.ops.group_norm import group_norm_plain

    kernels = (layers.attention, layers.group_norm, dit.attention,
               sd_unet.attention)
    layers.attention = dit.attention = sd_unet.attention = attention_plain
    layers.group_norm = (lambda x, s, b, *, groups, eps:
                         group_norm_plain(x, s, b, groups, eps))
    try:
        yield
    finally:
        (layers.attention, layers.group_norm, dit.attention,
         sd_unet.attention) = kernels


def model_check(model, gen) -> float:
    import torch

    dev = torch.device("cuda")
    x = torch.randn(8, 32, 32, 3, generator=gen, device=dev)
    t = torch.randint(0, 1000, (8,), generator=gen, device=dev)
    c = torch.randint(0, 10, (8,), generator=gen, device=dev)
    keep = torch.arange(8, device=dev) % 2 == 0
    with torch.inference_mode():
        got = model(x, t, c, keep)
        with plain_layers():
            want = model(x, t, c, keep)
    if not torch.isfinite(got).all():
        fail("batch-8 forward with kernels is not finite")
    rel = ((got - want).norm() / want.norm()).item()
    print(f"  batch-8 forward, kernels vs plain path: rel L2 err {rel:.3e} "
          f"(tolerance {MODEL_REL_L2:g}), max_abs_err "
          f"{(got - want).abs().max().item():.3e}", flush=True)
    if rel > MODEL_REL_L2:
        fail("the model with kernels disagrees with its plain path")
    return rel

def rel_l2(name: str, got, want, tol: float,
           against: str = "its plain version") -> float:
    """Relative L2 error of ``got`` against ``want`` (on the CPU, in
    float64); fails above ``tol``. Returns the max abs error."""
    import torch

    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if not torch.isfinite(got).all():
        fail(f"{name}: output is not finite")
    rel = ((got - want).norm() / want.norm()).item()
    max_abs = (got - want).abs().max().item()
    print(f"  {name}: rel L2 err {rel:.3e} (tolerance {tol:g}), max_abs_err "
          f"{max_abs:.3e}", flush=True)
    if not rel <= tol:
        fail(f"{name}: disagrees with {against}")
    return max_abs


def sdpa_backend_names(q, k, v, g=None) -> dict:
    """What SDPA runs by default at this shape: ``"backend"``, the one its
    dispatcher picks (``torch._fused_sdp_choice``), and ``"kernels"``, the
    device kernels of one forward (+ backward for a gradient g), named by
    the CUDA driver from a CUDA graph of the call. (A profile's device events
    named none for fp32 SDPA late in a whole run of this script.)"""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    ql, kl, vl = (t.detach().requires_grad_(g is not None) for t in (q, k, v))
    choice = int(torch._fused_sdp_choice(ql, kl, vl))
    backends = {int(b): name.lower()
                for name, b in SDPBackend.__members__.items()}

    def call():
        out = F.scaled_dot_product_attention(ql, kl, vl)
        if g is not None:
            torch.autograd.grad(out, (ql, kl, vl), g)

    call()
    torch.cuda.synchronize()
    kernels = sorted({name[:80] for kind, name in
                      enqueued_node_types(call, names=True)
                      if kind == GRAPH_KERNEL_NODE})
    return {"backend": backends.get(choice, str(choice)), "kernels": kernels}


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")


def sdpa_by_backend(q, k, v, iters: int = 10) -> dict:
    """Device ms of one SDPA forward (CUDA-graph replay) under each backend
    of ``torch.nn.attention.sdpa_kernel`` that takes these inputs (a
    backend that refuses them is left out), by lower-case backend name."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue

        def run(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(q, k, v)

        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                run()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        out[name.lower()] = time_ms(run, iters)[0]
    if not out:
        fail("no SDPA backend takes these inputs")
    return out


def library_bwd(fwd, inputs, g):
    """(fn, stream): the PyTorch library's backward alone, from a forward
    recorded on ``stream`` with its graph retained."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    leaves = [t.detach().requires_grad_() for t in inputs]
    with torch.cuda.stream(stream):
        out = fwd(*leaves)
    torch.cuda.current_stream().wait_stream(stream)
    return (lambda: torch.autograd.grad(out, leaves, g, retain_graph=True),
            stream)


def check_bwd_kernels(sites, batch: int, gen) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from uurg_torch.ops import flash_attention as FA
    from uurg_torch.ops import group_norm as GN
    from uurg_torch.ops.group_norm import (group_norm, group_norm_bwd,
                                           group_norm_bwd_plain)

    dev = torch.device("cuda")
    rows = []
    shapes = sorted({(k, s, g) for k, s, g in sites})
    for kind, (C, H, W), groups in shapes:
        count = sum(1 for s in sites if s == (kind, (C, H, W), groups))
        extra = {}
        if kind == "attn":
            T, D = H * W, C
            q, k, v, g = (torch.randn(batch, 1, T, D, generator=gen,
                                      device=dev, dtype=torch.bfloat16)
                          for _ in range(4))
            o, lse = FA._attention_kernel(q, k, v, with_lse=True)
            torch.cuda.synchronize()
            # the forward as the training path runs it: with the LSE output
            tag = f"attention fwd+lse B={batch} T={T} D={D}"
            fwd_abs = compare(tag, o, FA.attention_plain(q, k, v))
            check_lse(tag, lse, q, k)
            ms, eager_ms = time_ms(
                lambda: FA._attention_kernel(q, k, v, with_lse=True))
            plain_ms = time_ms(lambda: FA.attention_plain(q, k, v))[0]
            lib_ms = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v))[0]
            # q, k, v read, o written (the LSE is this design's output only)
            bytes_ms = 4 * batch * T * D * 2 / HBM_BYTES_PER_S * 1e3
            ops_ms = 4 * batch * T * T * D / BF16_TC_FLOPS * 1e3
            rows.append({
                "name": "attention_fwd_train",
                "shape": {"B": batch, "H": 1, "T": T, "D": D},
                "sites_per_forward": count, "ms": ms, "eager_ms": eager_ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "max_abs_err": fwd_abs})
            print(f"  attention_fwd_train {rows[-1]['shape']} x{count}/forward:"
                  f" kernel {ms:.4f} ms (eager {eager_ms:.4f} ms), plain "
                  f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                  f"{max(bytes_ms, ops_ms):.4f} ms ({rows[-1]['bound_by']})",
                  flush=True)
            got = FA.attention_bwd(q, k, v, o, lse, g)
            torch.cuda.synchronize()
            want = FA.attention_bwd_plain(q, k, v, g)
            max_abs = max(rel_l2(f"attention bwd d{n} B={batch} T={T} D={D}",
                                 a, b, BWD_REL_L2)
                          for n, a, b in zip("qkv", got, want))
            print(f"  SDPA kernels at this shape: "
                  f"{sdpa_backend_names(q, k, v, g)}", flush=True)
            lib, stream = library_bwd(F.scaled_dot_product_attention,
                                      (q, k, v), g)
            run = (lambda: FA.attention_bwd(q, k, v, o, lse, g),
                   lambda: FA.attention_bwd_plain(q, k, v, g))
            # what the function must move: q, k, v, g read, dq, dk, dv
            # written; o and the LSE are inputs of this design only
            nbytes = 7 * batch * T * D * 2
            ops, peak = 10 * batch * T * T * D, BF16_TC_FLOPS
            shape = {"B": batch, "H": 1, "T": T, "D": D}
            name = "attention_bwd"
        else:
            x = (torch.randn(batch, H, W, C, generator=gen, device=dev) * 2
                 + 0.5).to(torch.bfloat16)
            g = torch.randn(batch, H, W, C, generator=gen,
                            device=dev).to(torch.bfloat16)
            scale = torch.randn(C, generator=gen, device=dev) * 0.2 + 1.0
            bias = torch.randn(C, generator=gen, device=dev) * 0.2
            _, mean, rstd = group_norm(x, scale, bias, groups=groups,
                                       return_stats=True)
            route, cluster = GN._bwd_route(H * W, C, x.element_size(),
                                           groups, batch)
            got = group_norm_bwd(x, scale, mean, rstd, g)
            torch.cuda.synchronize()
            want = group_norm_bwd_plain(x, scale, mean, rstd, g)
            tag = f"B={batch} H={H} W={W} C={C} ({route}, cluster {cluster})"
            per_call = 2 if route == "split" else 1
            one_launch(f"group_norm bwd {tag}",
                       lambda: group_norm_bwd(x, scale, mean, rstd, g),
                       per_call)
            extra = {"route": route, "cluster": cluster,
                     "kernels_per_call": per_call}
            max_abs = max(compare(f"group_norm bwd dx {tag}", got[0], want[0]),
                          rel_l2(f"group_norm bwd dscale {tag}", got[1],
                                 want[1], GN_SUM_REL_L2),
                          rel_l2(f"group_norm bwd dbias {tag}", got[2],
                                 want[2], GN_SUM_REL_L2))
            s16, b16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
            lib, stream = library_bwd(
                lambda a, w, b: F.group_norm(a, groups, w, b, 1e-6),
                (x.permute(0, 3, 1, 2), s16, b16), g.permute(0, 3, 1, 2))
            run = (lambda: group_norm_bwd(x, scale, mean, rstd, g),
                   lambda: group_norm_bwd_plain(x, scale, mean, rstd, g))
            numel = batch * H * W * C
            nbytes = 3 * numel * 2 + 3 * C * 4 + 2 * batch * groups * 4
            ops, peak = 10 * numel, FP32_FLOPS
            shape = {"B": batch, "H": H, "W": W, "C": C, "G": groups}
            name = "group_norm_bwd"
        ms, eager_ms = time_ms(run[0])
        plain_ms = time_ms(run[1])[0]
        lib_ms = time_ms(lib, stream=stream)[0]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / peak * 1e3
        rows.append({
            "name": name, "shape": shape, "sites_per_forward": count,
            "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": max_abs, **extra,
        })
        print(f"  {name} {shape} x{count}/backward: kernel {ms:.4f} ms "
              f"(eager {eager_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} "
              f"ms ({rows[-1]['bound_by']})"
              + (f"; {extra['route']} route, cluster {extra['cluster']}"
                 if extra else ""), flush=True)
    return rows


def enqueued_node_types(fn, names: bool = False) -> list:
    """The CUgraphNodeType of each operation that one call of ``fn``
    enqueues, read from a CUDA graph the call is captured into (the call is
    not run). With ``names``, (type, name) pairs: a kernel node's function
    name as the CUDA driver gives it (mangled; "?" where it gives none), None
    for other nodes."""
    import ctypes

    import torch

    class KernelParams(ctypes.Structure):   # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("dims", ctypes.c_uint * 7),
                    ("kernel_params", ctypes.c_void_p),
                    ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                    ("ctx", ctypes.c_void_p)]

    def kernel_name(node) -> str:
        params, name = KernelParams(), ctypes.c_char_p()
        try:
            if cuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                  ctypes.byref(params)):
                return "?"
            if params.func and not cuda.cuFuncGetName(
                    ctypes.byref(name), ctypes.c_void_p(params.func)):
                return name.value.decode()
            if params.kern and not cuda.cuKernelGetName(
                    ctypes.byref(name), ctypes.c_void_p(params.kern)):
                return name.value.decode()
        except AttributeError:          # a driver without these entry points
            pass
        return "?"

    cuda = ctypes.CDLL("libcuda.so.1")
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    err = cuda.cuGraphGetNodes(handle, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    if not err and n.value:
        err = cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n))
    types = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        err = err or cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                             ctypes.byref(kind))
        types.append((kind.value, kernel_name(node)
                      if kind.value == GRAPH_KERNEL_NODE else None)
                     if names else kind.value)
    if err:
        fail(f"reading a captured graph's nodes: CUDA driver error {err}")
    return types


def kernels_a_call(fn) -> int:
    """Kernels that one call of ``fn`` enqueues, counted in a CUDA graph of
    the call."""
    return enqueued_node_types(fn).count(GRAPH_KERNEL_NODE)


def one_launch(name: str, fn, kernels: int = 1) -> None:
    """Fails unless one call of ``fn`` enqueues exactly ``kernels``
    operations, all kernels (no copy, no fill), on the device. Read from a
    CUDA graph of the call, which lists every operation: the profiler
    dropped the record of a kernel that had launched in about 1 call of 200
    (``scripts/check_one_launch.py`` on an H100)."""
    types = enqueued_node_types(fn)
    if types != [GRAPH_KERNEL_NODE] * kernels:
        fail(f"{name}: one call enqueued the graph nodes {types} "
             f"(CUgraphNodeType; {GRAPH_KERNEL_NODE} is a kernel), not "
             f"{kernels} kernel(s)")


def check_lse(name: str, lse, q, k) -> float:
    """The forward kernel's fp32 (B*H, T) log-sum-exp against
    ``torch.logsumexp`` of the scaled fp32 scores."""
    import torch

    T, D = q.shape[-2:]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * D ** -0.5
    err = (lse - torch.logsumexp(s, -1).reshape(-1, T)).abs().max().item()
    print(f"  {name}: lse max_abs_err {err:.3e} (tolerance {LSE_ATOL:g})",
          flush=True)
    if not err <= LSE_ATOL:
        fail(f"{name}: the log-sum-exp disagrees with torch.logsumexp")
    return err


def mhsa_views(B: int, H: int, T: int, D: int, gen, dtype=None):
    """(q, k, v, g) in the layout DiT's MHSA hands the dispatcher: q, k, v
    the (B, H, T, D) views that ``MHSA.heads`` takes of one fused
    (B, T, 3, H, D) projection, g the (B, H, T, D) view of a token-major
    (B, T, H, D) gradient that ``MHSA.merge``'s backward gives. Seeded
    normal values, bf16 unless ``dtype`` says otherwise."""
    import torch

    dtype = dtype or torch.bfloat16
    qkv = torch.randn(B, T, 3, H, D, generator=gen, device="cuda",
                      dtype=dtype)
    g = torch.randn(B, T, H, D, generator=gen, device="cuda", dtype=dtype)
    return (*(t.transpose(1, 2) for t in qkv.unbind(2)), g.transpose(1, 2))


def pad_ops(fn) -> int:
    """How many zero pads (``aten::constant_pad_nd``, what ``F.pad`` runs)
    one call of ``fn`` makes, from torch.profiler's CPU operator records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key == "aten::constant_pad_nd")


def check_ragged(gen) -> list[dict]:
    """Phase 9: both attention kernels at shapes off the main path."""
    import torch

    from uurg_torch.ops import flash_attention as FA

    rows = []
    for T, D in RAGGED_SHAPES:
        q, k, v, g = (torch.randn(4, 2, T, D, generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(4))
        tag = f"B=4 H=2 T={T} D={D}"
        o, lse = FA._attention_kernel(q, k, v, with_lse=True)
        torch.cuda.synchronize()
        fwd_err = compare(f"attention {tag}", o, FA.attention_plain(q, k, v))
        lse_err = check_lse(f"attention {tag}", lse, q, k)
        got = FA.attention_bwd(q, k, v, o, lse, g)
        torch.cuda.synchronize()
        want = FA.attention_bwd_plain(q, k, v, g)
        bwd_err = max(rel_l2(f"attention bwd d{n} {tag}", a, b, BWD_REL_L2)
                      for n, a, b in zip("qkv", got, want))
        for _ in range(RAGGED_REPEATS - 1):
            o2, lse2 = FA._attention_kernel(q, k, v, with_lse=True)
            again = FA.attention_bwd(q, k, v, o, lse, g)
            if not (torch.equal(o2, o) and torch.equal(lse2, lse)
                    and all(torch.equal(a, b) for a, b in zip(got, again))):
                fail(f"attention {tag}: repeated runs differ in their bits")
        rows.append({"T": T, "D": D, "fwd_max_abs_err": fwd_err,
                     "lse_max_abs_err": lse_err, "bwd_max_abs_err": bwd_err})
    print(f"  {len(rows)} shapes, {RAGGED_REPEATS} runs each with equal bits",
          flush=True)
    return rows


def attention_f32_path(gen) -> tuple[list[dict], list[dict]]:
    """Phase 16: the float32 attention kernels against their plain versions
    on the card (TF32 off) at F32_SHAPES and RAGGED_SHAPES: the forward,
    its log-sum-exp against ``torch.logsumexp`` and the backward, each
    three times with equal bits; then at the two ViT shapes the kernel, the
    plain version and float32 SDPA (and SDPA's backward) timed by
    CUDA-graph replay. Returns (summary rows of the 224 px shape for the
    kernels line, per-shape details)."""
    import torch
    import torch.nn.functional as F

    from uurg_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = list(F32_SHAPES) + [(4, 2, T, D) for T, D in RAGGED_SHAPES]
    rows, detail = [], []
    for B, H, T, D in shapes:
        q, k, v, g = (torch.randn(B, H, T, D, generator=gen, device="cuda")
                      for _ in range(4))
        route = FA._f32_plan(B, H, T, D).route
        tag = f"f32 {route} B={B} H={H} T={T} D={D}"
        before = (FA.attention.launches, FA.attention_bwd.launches)
        o, lse = FA._attention_kernel(q, k, v, with_lse=True)
        o = o.contiguous()             # a column slice where D was padded
        got = FA.attention_bwd(q, k, v, o, lse, g)
        torch.cuda.synchronize()
        if (FA.attention.launches, FA.attention_bwd.launches) != before:
            fail(f"attention {tag}: a float32 call counted as bf16")
        fwd_abs = rel_l2(f"attention {tag}", o, FA.attention_plain(q, k, v),
                         F32_FWD_REL)
        lse_err = check_lse(f"attention {tag}", lse, q, k)
        want = FA.attention_bwd_plain(q, k, v, g)
        bwd_abs = max(rel_l2(f"attention bwd d{n} {tag}", a, b, F32_BWD_REL)
                      for n, a, b in zip("qkv", got, want))
        for _ in range(RAGGED_REPEATS - 1):
            o2, lse2 = FA._attention_kernel(q, k, v, with_lse=True)
            again = FA.attention_bwd(q, k, v, o, lse, g)
            if not (torch.equal(o2.contiguous(), o) and torch.equal(lse2, lse)
                    and all(torch.equal(a, b) for a, b in zip(got, again))):
                fail(f"attention {tag}: repeated runs differ in their bits")
        info = {"shape": {"B": B, "H": H, "T": T, "D": D},
                "route": route,
                "fwd_max_abs_err": fwd_abs, "lse_max_abs_err": lse_err,
                "bwd_max_abs_err": bwd_abs}
        detail.append(info)
        if (B, H, T, D) not in F32_SHAPES[:2]:
            continue
        lib, stream = library_bwd(F.scaled_dot_product_attention,
                                  (q, k, v), g)
        fwd = {"ms": time_ms(lambda: FA._attention_kernel(
                   q, k, v, with_lse=True)),
               "plain_ms": time_ms(lambda: FA.attention_plain(q, k, v)),
               "library_ms": time_ms(
                   lambda: F.scaled_dot_product_attention(q, k, v))}
        bwd = {"ms": time_ms(lambda: FA.attention_bwd(q, k, v, o, lse, g)),
               "plain_ms": time_ms(
                   lambda: FA.attention_bwd_plain(q, k, v, g)),
               "library_ms": time_ms(lib, stream=stream)}
        n = B * H * T * D
        for name, t, nbytes, ops, err in (
                ("attention_fwd_f32", fwd, 4 * n * 4, 4 * n * T, fwd_abs),
                ("attention_bwd_f32", bwd, 7 * n * 4, 10 * n * T, bwd_abs)):
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / FP32_FLOPS * 1e3
            row = {"name": name, "shape": info["shape"],
                   "sites_per_forward": VIT_BLOCKS, "ms": t["ms"][0],
                   "eager_ms": t["ms"][1], "plain_ms": t["plain_ms"][0],
                   "library_ms": t["library_ms"][0], "bytes_ms": bytes_ms,
                   "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": ("bytes" if bytes_ms >= ops_ms
                                else "operations"),
                   "max_abs_err": err}
            info[name] = row
            if (B, H, T, D) == F32_VIT_SHAPE:
                rows.append(row)
            print(f"  {name} {info['shape']}: kernel {row['ms']:.4f} ms "
                  f"(eager {row['eager_ms']:.4f} ms), plain "
                  f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} "
                  f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
                  flush=True)
    print(f"  {len(detail)} shapes held (forward {F32_FWD_REL:g}, backward "
          f"{F32_BWD_REL:g}), {RAGGED_REPEATS} runs each with equal bits",
          flush=True)
    return rows, detail


def gn_routes(hw: int, c: int, itemsize: int, groups: int,
              backward: bool = False, batch: int = 1) -> list:
    """Every route of the GroupNorm forward (or backward) that can run this
    shape: the wrapper's choice first, then ``split`` at its count of runs
    for ``batch`` and at one run a sample, then ``slab`` at every other
    cluster size whose block fits shared memory."""
    from uurg_torch.ops import group_norm as GN

    if backward:
        first = [GN._bwd_route(hw, c, itemsize, groups, batch),
                 ("split", GN._bwd_split_count(batch, hw, c, itemsize)),
                 ("split", 1)]
        smem = GN._bwd_slab_smem
    else:
        first = [GN._fwd_route(hw, c, itemsize, groups, batch),
                 ("split", GN._split_count(batch, hw, c, itemsize)),
                 ("split", 1)]
        smem = GN._slab_smem
    fit = [("slab", s) for s in GN._CLUSTERS if s < hw
           and c * itemsize % 16 == 0
           and smem(hw, c, itemsize, groups, s) <= GN._SMEM_MAX]
    return list(dict.fromkeys(first + fit))


def check_gn_offpath(gen) -> list[dict]:
    """Phase 10: the GroupNorm forward at shapes off the main path, on
    every route that can run them (the wrapper's choice, ``split`` at the
    wrapper's count of runs and at one run a sample, and ``slab`` at each
    cluster size that fits: at H W = 25, 441 or 841 the slices of a cluster
    differ in length, and so do a split's runs)."""
    import torch

    from uurg_torch.ops import group_norm as GN

    rows = []
    for B, H, C, dtype_name in GN_OFFPATH_SHAPES:
        dtype = getattr(torch, dtype_name)
        x = (torch.randn(B, H, H, C, generator=gen, device="cuda") * 2
             + 0.5).to(dtype)
        scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
        bias = torch.randn(C, generator=gen, device="cuda") * 0.2
        groups = 32
        while C % groups:
            groups //= 2                 # as the dispatcher does
        want = GN.group_norm_plain(x, scale, bias, groups, 1e-6, True)
        chosen = GN._fwd_route(H * H, C, x.element_size(), groups, B)
        tol = (ATOL, RTOL) if dtype == torch.bfloat16 else \
            (GN_FP32_ATOL, GN_FP32_RTOL)
        errs = {}
        for route in gn_routes(H * H, C, x.element_size(), groups,
                               batch=B):
            tag = (f"group_norm B={B} H=W={H} C={C} G={groups} {dtype_name} "
                   f"({route[0]}, cluster {route[1]})")
            got = GN._group_norm_kernel(x, scale, bias, groups, 1e-6,
                                        route=route)
            torch.cuda.synchronize()
            errs[f"{route[0]}{route[1]}"] = compare(tag, got[0], want[0],
                                                    *tol)
            compare(f"{tag} mean", got[1], want[1], GN_FP32_ATOL,
                    GN_FP32_RTOL)
            compare(f"{tag} rstd", got[2], want[2], GN_RSTD_TOL, GN_RSTD_TOL)
            for _ in range(RAGGED_REPEATS - 1):
                again = GN._group_norm_kernel(x, scale, bias, groups, 1e-6,
                                              route=route)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"{tag}: repeated runs differ in their bits")
        rows.append({"B": B, "H": H, "W": H, "C": C, "G": groups,
                     "dtype": dtype_name, "route": chosen[0],
                     "cluster": chosen[1], "max_abs_err": errs})
    print(f"  {len(rows)} shapes, {RAGGED_REPEATS} runs each with equal bits",
          flush=True)
    return rows


def check_gn_bwd_offpath(gen) -> list[dict]:
    """Phase 11: the GroupNorm backward at shapes off the main path and at
    the main path's shapes at batch 256, on every route that can run them,
    dx, dscale and dbias against the plain version, three runs with equal
    bits."""
    import torch

    from uurg_torch.ops import group_norm as GN

    rows = []
    shapes = GN_BWD_OFFPATH_SHAPES + tuple(
        (2 * TRAIN_BATCH, H, C, "bfloat16") for H, C, _ in GN_SITES)
    for B, H, C, dtype_name in shapes:
        dtype = getattr(torch, dtype_name)
        x = (torch.randn(B, H, H, C, generator=gen, device="cuda") * 2
             + 0.5).to(dtype)
        g = torch.randn(B, H, H, C, generator=gen, device="cuda").to(dtype)
        scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
        groups = 32
        while C % groups:
            groups //= 2                 # as the dispatcher does
        _, mean, rstd = GN.group_norm_plain(x, scale, scale, groups, 1e-6,
                                            True)
        want = GN.group_norm_bwd_plain(x, scale, mean, rstd, g)
        size = x.element_size()
        chosen = GN._bwd_route(H * H, C, size, groups, B)
        tol = (ATOL, RTOL) if dtype == torch.bfloat16 else \
            (GN_BWD_FP32_TOL, GN_BWD_FP32_TOL)
        errs = {}
        for route in gn_routes(H * H, C, size, groups, backward=True,
                               batch=B):
            tag = (f"group_norm bwd B={B} H=W={H} C={C} G={groups} "
                   f"{dtype_name} ({route[0]}, cluster {route[1]})")
            got = GN._group_norm_bwd_kernel(x, scale, mean, rstd, g,
                                            route=route)
            torch.cuda.synchronize()
            errs[f"{route[0]}{route[1]}"] = max(
                compare(f"{tag} dx", got[0], want[0], *tol),
                rel_l2(f"{tag} dscale", got[1], want[1], GN_SUM_REL_L2),
                rel_l2(f"{tag} dbias", got[2], want[2], GN_SUM_REL_L2))
            for _ in range(RAGGED_REPEATS - 1):
                again = GN._group_norm_bwd_kernel(x, scale, mean, rstd, g,
                                                  route=route)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"{tag}: repeated runs differ in their bits")
        rows.append({"B": B, "H": H, "W": H, "C": C, "G": groups,
                     "dtype": dtype_name, "route": chosen[0],
                     "cluster": chosen[1], "max_abs_err": errs})
    print(f"  {len(rows)} shapes, {RAGGED_REPEATS} runs each with equal bits",
          flush=True)
    return rows


def grad_check(model, wl, gen) -> float:
    """One eps-loss backward at batch 8 with the kernels against the same
    model on its plain path (dropout off, the same t, noise and labels)."""
    import torch

    from uurg_torch.ops.flash_attention import attention_bwd
    from uurg_torch.ops.group_norm import group_norm_bwd

    dev = torch.device("cuda")
    x = torch.rand(8, 32, 32, 3, generator=gen, device=dev) * 2 - 1
    noise = torch.randn(8, 32, 32, 3, generator=gen, device=dev)
    t = torch.randint(0, 1000, (8,), generator=gen, device=dev)
    c = torch.randint(0, 10, (8,), generator=gen, device=dev)
    keep = torch.arange(8, device=dev) % 2 == 0
    model.eval()

    def grads():
        model.zero_grad(set_to_none=True)
        wl.per_sample_eps_loss(model, x, c, t, noise, keep).mean().backward()
        out = torch.cat([p.grad.float().reshape(-1) for p in model.parameters()])
        model.zero_grad(set_to_none=True)
        return out

    bwd = (attention_bwd.launches, group_norm_bwd.launches)
    got = grads()
    if (attention_bwd.launches - bwd[0], group_norm_bwd.launches - bwd[1]) \
            == (0, 0):
        fail("the batch-8 backward did not go through the backward kernels")
    with plain_layers():
        want = grads()
    if not torch.isfinite(got).all():
        fail("batch-8 gradients with kernels are not finite")
    rel = ((got - want).norm() / want.norm()).item()
    print(f"  batch-8 parameter gradients ({got.numel()} values), kernels vs "
          f"plain path: rel L2 err {rel:.3e} (tolerance "
          f"{MODEL_GRAD_REL_L2:g})", flush=True)
    if rel > MODEL_GRAD_REL_L2:
        fail("the model's gradients with kernels disagree with its plain path")
    return rel


def _zero_launches() -> None:
    from uurg_torch.ops.flash_attention import attention, attention_bwd
    from uurg_torch.ops.group_norm import group_norm, group_norm_bwd

    attention.launches = attention_bwd.launches = 0
    attention.launches_f32 = attention_bwd.launches_f32 = 0
    attention.launches_xwide = attention_bwd.launches_xwide = 0
    group_norm.launches = group_norm_bwd.launches = 0


def _read_all_launches() -> dict:
    """The four bf16/GroupNorm counts and the float32 attention routes'."""
    from uurg_torch.ops.flash_attention import attention, attention_bwd

    return {**_read_launches(),
            "attention_fwd_f32": attention.launches_f32,
            "attention_bwd_f32": attention_bwd.launches_f32}


def _read_launches() -> dict:
    from uurg_torch.ops.flash_attention import attention, attention_bwd
    from uurg_torch.ops.group_norm import group_norm, group_norm_bwd

    return {"attention_fwd": attention.launches,
            "attention_bwd": attention_bwd.launches,
            "group_norm_fwd": group_norm.launches,
            "group_norm_bwd": group_norm_bwd.launches}


@contextlib.contextmanager
def step_clock(runner):
    """Wrap the runner's SFR-on step: after each step, wait for the device
    and read the clock, and keep the step's metrics. The run still goes
    through the runner's own entry point and step."""
    import torch

    record = {"t": [], "metrics": []}
    make = runner.make_sfron_step

    def timed_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(*a, **k):
            metrics = step(*a, **k)
            torch.cuda.synchronize()
            record["t"].append(time.perf_counter())
            record["metrics"].append(metrics)
            return metrics

        return timed

    runner.make_sfron_step = timed_make
    try:
        yield record
    finally:
        runner.make_sfron_step = make


def train_path(config, card: str, n_attn: int, n_gn: int) -> dict:
    """Phase 8: sfron_forget on the full-width config; returns its numbers
    and the kernels' launch counts of the counted run."""
    import numpy as np
    import torch

    from uurg_torch.core.tree import pack_mask, sparsity
    from uurg_torch.io.jax_interop import load_reference_checkpoint
    from uurg_torch.models.unet_cond import CondUNet
    from uurg_torch.workloads import ddpm_runner as R
    from uurg_torch.workloads.ddpm import DDPMWorkload

    class Args:
        seed = SEED
        ckpt_folder = None             # a seeded init through load_params
        label_to_forget = 0
        forget_alpha = FORGET_ALPHA
        method = "ron"
        unlearn_loss = "adaga"

    wl = DDPMWorkload.from_config(config)
    init = R.load_params(Args, config, wl)
    gen = torch.Generator().manual_seed(SEED)
    mask = pack_mask({k: torch.rand(p.shape, generator=gen) < 0.5
                      for k, p in init.named_parameters()})
    print(f"  mask: packed, density {1 - sparsity(mask):.4f}", flush=True)
    ckpt_dir = tempfile.mkdtemp(prefix="uurg_sfron_")
    try:
        warm = config.merged({"training": {"n_iters": WARMUP_STEPS,
                                           "snapshot_freq": 10 ** 6}})
        R.sfron_forget(Args, warm, ckpt_dir, mask=mask)   # warm-up
        timed_cfg = config.merged({"training": {
            "n_iters": WARMUP_STEPS + TRAIN_STEPS, "snapshot_freq": 10 ** 6,
            "log_freq": 10 ** 6}})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with step_clock(R) as rec:
            _zero_launches()
            t0 = time.time()
            state = R.sfron_forget(Args, timed_cfg, ckpt_dir, mask=mask)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = _read_launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        if state.step != WARMUP_STEPS + TRAIN_STEPS or \
                len(rec["metrics"]) != TRAIN_STEPS:
            fail(f"sfron_forget ran {len(rec['metrics'])} counted steps to "
                 f"step {state.step}, not {TRAIN_STEPS} from "
                 f"{WARMUP_STEPS}")
        losses = [(float(m["forget_loss"]), float(m["remain_loss"]))
                  for m in rec["metrics"]]
        if not np.isfinite(losses).all():
            fail(f"a forget or remain loss is not finite: {losses}")
        moved = sum(not torch.equal(p, q) for p, q in
                    zip(state.model.parameters(), init.parameters()))
        ema_moved = sum(not torch.equal(p, q) for p, q in
                        zip(state.ema_model.parameters(), init.parameters()))
        n_leaves = len(list(init.parameters()))
        print(f"  {moved}/{n_leaves} parameter tensors and {ema_moved} EMA "
              f"tensors moved", flush=True)
        if moved < n_leaves // 2 or ema_moved < n_leaves // 2:
            fail("the parameters or the EMA did not move")
        want = {"attention_fwd": n_attn * 2 * TRAIN_STEPS,
                "attention_bwd": n_attn * 2 * TRAIN_STEPS,
                "group_norm_fwd": n_gn * 2 * TRAIN_STEPS,
                "group_norm_bwd": n_gn * 2 * TRAIN_STEPS}
        print(f"  launches: {launches} (expected {want})", flush=True)
        if launches != want:
            fail("not every attention/GroupNorm site of the training step "
                 "went through its forward and backward kernels")
        step_s = np.diff(rec["t"])          # TRAIN_STEPS - 1 step times
        print(f"  {TRAIN_STEPS} steps (batch {TRAIN_BATCH} forget + "
              f"{TRAIN_BATCH} remain): median {np.median(step_s) * 1e3:.3f} "
              f"ms/step ({1 / np.median(step_s):.3f} steps/s), min "
              f"{step_s.min() * 1e3:.3f}, max {step_s.max() * 1e3:.3f} ms; "
              f"call {wall:.3f} s with init, resume and checkpoint; peak "
              f"device memory {peak_gib:.3f} GiB; on {card}", flush=True)
        print(f"  losses: forget {losses[0][0]:.4f} -> {losses[-1][0]:.4f}, "
              f"remain {losses[0][1]:.4f} -> {losses[-1][1]:.4f}", flush=True)

        path = os.path.join(ckpt_dir, "ckpt.pth")
        shadow = CondUNet(wl.unet_cfg)
        step = load_reference_checkpoint(path, shadow, use_ema=True)
        shadow = shadow.to(wl.device).eval()
        for a, b in zip(shadow.parameters(), state.ema_model.parameters()):
            if not torch.equal(a, b):
                fail("ckpt.pth does not hold the run's EMA shadow")
        imgs = R.sample_images(Args, config, shadow, np.arange(8),
                               num_steps=DDIM_STEPS, cond_scale=COND_SCALE,
                               batch_size=8, seed=SEED)
        if imgs.shape != (8, 32, 32, 3) or imgs.dtype != np.uint8 or \
                imgs.std() == 0:
            fail(f"sampling the unlearned ckpt.pth gave {imgs.shape} "
                 f"{imgs.dtype} std {imgs.std()}")
        print(f"  ckpt.pth (step {step}, EMA) sampled: 8 images, mean "
              f"{imgs.mean():.2f} std {imgs.std():.2f}", flush=True)
    finally:
        for name in os.listdir(ckpt_dir):
            os.remove(os.path.join(ckpt_dir, name))
        os.rmdir(ckpt_dir)
    return {"launches": launches, "steps": TRAIN_STEPS,
            "step_ms": (step_s * 1e3).tolist(),
            "median_step_ms": float(np.median(step_s) * 1e3),
            "steps_per_s": float(1 / np.median(step_s)),
            "call_seconds": wall, "peak_gib": peak_gib, "losses": losses}


def check_batch_kernels(sites, gen, attn_batches, gn_batches) -> dict:
    """The four kernels against their plain versions at every site shape of
    a pass, attention at ``attn_batches``, GroupNorm at ``gn_batches``,
    three runs each with equal bits (phases 12 and 13)."""
    import torch

    from uurg_torch.ops import flash_attention as FA
    from uurg_torch.ops.group_norm import (group_norm, group_norm_bwd,
                                           group_norm_bwd_plain,
                                           group_norm_plain)

    dev = torch.device("cuda")
    errs = {}
    attn = sorted({(s[1][1] * s[1][2], s[1][0]) for s in sites
                   if s[0] == "attn"})
    for B in attn_batches:
        for T, D in attn:
            q, k, v, g = (torch.randn(B, 1, T, D, generator=gen, device=dev,
                                      dtype=torch.bfloat16) for _ in range(4))
            tag = f"attention B={B} T={T} D={D}"
            o, lse = FA._attention_kernel(q, k, v, with_lse=True)
            torch.cuda.synchronize()
            fwd = compare(tag, o, FA.attention_plain(q, k, v))
            check_lse(tag, lse, q, k)
            got = FA.attention_bwd(q, k, v, o, lse, g)
            torch.cuda.synchronize()
            bwd = max(rel_l2(f"attention bwd d{n} B={B} T={T} D={D}", a, b,
                             BWD_REL_L2)
                      for n, a, b in zip("qkv", got,
                                         FA.attention_bwd_plain(q, k, v, g)))
            for _ in range(RAGGED_REPEATS - 1):
                o2, lse2 = FA._attention_kernel(q, k, v, with_lse=True)
                again = FA.attention_bwd(q, k, v, o, lse, g)
                if not (torch.equal(o2, o) and torch.equal(lse2, lse)
                        and all(torch.equal(a, b) for a, b in zip(got, again))):
                    fail(f"{tag}: repeated runs differ in their bits")
            errs[f"attention B={B} T={T}"] = {"fwd": fwd, "bwd": bwd}
    gn = sorted({(s[1], s[2]) for s in sites if s[0] == "gn"})
    for B in gn_batches:
        for (C, H, W), groups in gn:
            x = (torch.randn(B, H, W, C, generator=gen, device=dev) * 2
                 + 0.5).to(torch.bfloat16)
            g = torch.randn(B, H, W, C, generator=gen,
                            device=dev).to(torch.bfloat16)
            scale = torch.randn(C, generator=gen, device=dev) * 0.2 + 1.0
            bias = torch.randn(C, generator=gen, device=dev) * 0.2
            tag = f"group_norm B={B} H={H} W={W} C={C}"
            y, mean, rstd = group_norm(x, scale, bias, groups=groups,
                                       return_stats=True)
            got = group_norm_bwd(x, scale, mean, rstd, g)
            torch.cuda.synchronize()
            fwd = compare(tag, y, group_norm_plain(x, scale, bias, groups,
                                                   1e-6))
            want = group_norm_bwd_plain(x, scale, mean, rstd, g)
            bwd = max(compare(f"{tag} bwd dx", got[0], want[0]),
                      rel_l2(f"{tag} bwd dscale", got[1], want[1],
                             GN_SUM_REL_L2),
                      rel_l2(f"{tag} bwd dbias", got[2], want[2],
                             GN_SUM_REL_L2))
            for _ in range(RAGGED_REPEATS - 1):
                again = group_norm(x, scale, bias, groups=groups,
                                   return_stats=True)
                again_bwd = group_norm_bwd(x, scale, mean, rstd, g)
                if not all(torch.equal(a, b) for a, b in
                           zip((*again, *again_bwd), (y, mean, rstd, *got))):
                    fail(f"{tag}: repeated runs differ in their bits")
            errs[f"group_norm B={B} H={H} C={C}"] = {"fwd": fwd, "bwd": bwd}
    print(f"  {len(errs)} shapes, {RAGGED_REPEATS} runs each with equal bits",
          flush=True)
    return errs


def fisher_batch_check(model, wl, gen) -> float:
    """One Fisher batch (batch 8, CFG 16, eval mode) with the kernels
    against the same model on its plain path: the squared gradients."""
    import torch

    from uurg_torch.ops.flash_attention import attention_bwd
    from uurg_torch.ops.group_norm import group_norm_bwd

    dev = torch.device("cuda")
    x = torch.rand(8, 32, 32, 3, generator=gen, device=dev) * 2 - 1
    noise = torch.randn(8, 32, 32, 3, generator=gen, device=dev)
    t = torch.randint(0, 1000, (8,), generator=gen, device=dev)
    c = torch.randint(0, 10, (8,), generator=gen, device=dev)
    model.eval()
    params = list(model.parameters())

    def fisher():
        loss = wl.fisher_loss(model, x, c, t, noise, COND_SCALE)
        grads = torch.autograd.grad(loss, params)
        return torch.cat([g.float().reshape(-1) ** 2 for g in grads])

    bwd = (attention_bwd.launches, group_norm_bwd.launches)
    got = fisher()
    if (attention_bwd.launches - bwd[0], group_norm_bwd.launches - bwd[1]) \
            == (0, 0):
        fail("the Fisher batch did not go through the backward kernels")
    with plain_layers():
        want = fisher()
    if not torch.isfinite(got).all():
        fail("the Fisher batch with kernels is not finite")
    rel = ((got - want).norm() / want.norm()).item()
    print(f"  batch-8 Fisher (CFG 16, {got.numel()} values), kernels vs "
          f"plain path: rel L2 err {rel:.3e} (tolerance {FISHER_REL_L2:g})",
          flush=True)
    if rel > FISHER_REL_L2:
        fail("the Fisher with kernels disagrees with the plain path")
    return rel


@contextlib.contextmanager
def batch_clock(factory: str):
    """Wrap the Fisher batch step that ``uurg_torch.unlearn.fisher.<factory>``
    builds (``make_fisher_batch_step`` for ``generate_fisher``,
    ``make_per_sample_fisher_step`` for ``cli/fim.py``): host clock around
    each batch, between two waits for the device. The run still goes
    through the entry point's own step; ``record["step"]`` is the last step
    built, timed."""
    import torch

    from uurg_torch.unlearn import fisher as F

    record = {"s": [], "batch": []}
    make = getattr(F, factory)

    def timed_make(loss_fn):
        step = make(loss_fn)

        def timed(fisher, model, batch, gen_or_seed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(fisher, model, batch, gen_or_seed)
            torch.cuda.synchronize()
            record["s"].append(time.perf_counter() - t0)
            record["batch"].append(int(batch[0].shape[0]))

        record["step"] = timed
        return timed

    setattr(F, factory, timed_make)
    try:
        yield record
    finally:
        setattr(F, factory, make)


def fisher_device_ms(wl, model, batch,
                     iters: int = 3) -> tuple[float, float]:
    """(stream ms by CUDA events, device busy ms by the profiler) of one
    Fisher batch at CFG batch 2 x len(batch), after one warm-up batch. The
    events span ``iters`` batches launched back to back, so where the host
    launches slower than the device runs they read the host's pace; the
    profiler sums the device kernels' own times."""
    import torch

    from uurg_torch.unlearn.fisher import make_fisher_batch_step

    step = make_fisher_batch_step(wl.fisher_loss_fn(COND_SCALE))
    fisher = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    gen = torch.Generator(device=wl.device).manual_seed(SEED)
    step(fisher, model, batch, gen)
    torch.cuda.synchronize()
    stream_ms = _events_ms(
        lambda: [step(fisher, model, batch, gen) for _ in range(iters)],
        iters)
    return stream_ms, device_busy_ms("a Fisher batch",
                                     lambda: step(fisher, model, batch, gen))


# Runs whose kernels the profiler did not see, timed by CUDA events instead.
PROFILER_MISSES: list[dict] = []


def profiled_kernels(name: str, run) -> tuple[list, str, float]:
    """(the device kernels' profiler records, the key of their own time in
    microseconds, the stream ms by CUDA events) of one ``run()``. CUPTI's
    tracing has come back empty for a run that launched kernels, one run
    of many in a process; the records are then [], the run is named in
    PROFILER_MISSES and printed, and its caller reads the events' ms, a
    stream span with the device's idle gaps in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    stream_ms = start.elapsed_time(end)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    key = ("self_device_time_total" if events
           and hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    if sum(getattr(e, key) for e in events) > 0:
        return events, key, stream_ms
    if stream_ms <= 0:
        fail(f"neither the profiler nor CUDA events saw device time in "
             f"{name}")
    PROFILER_MISSES.append({"run": name, "stream_ms": stream_ms})
    print(f"  the profiler saw no device time in {name}: {stream_ms:.3f} ms "
          f"by CUDA events stand in (a stream span, idle gaps included)",
          flush=True)
    return [], key, stream_ms


def device_busy_ms(name: str, run) -> float:
    """The device kernels' own times summed over one ``run()``, by the
    profiler (by CUDA events where it saw none: ``profiled_kernels``)."""
    events, key, stream_ms = profiled_kernels(name, run)
    if not events:
        return stream_ms
    return sum(getattr(e, key) for e in events) / 1e3


def fisher_path(config, card: str, n_attn: int, n_gn: int, gen) -> dict:
    """Phase 12: Fisher diagonals, Fisher-ratio masks, SFR-on under a mask
    file, the SalUn mask and SalUn steps, through the runner's entry points
    on the full-width config."""
    import shutil

    import numpy as np
    import torch

    from uurg_torch.core.tree import sparsity, tree_count_nonzero
    from uurg_torch.data.splits import class_forget_split
    from uurg_torch.io.checkpoint import restore_checkpoint
    from uurg_torch.workloads import ddpm_runner as R
    from uurg_torch.workloads.ddpm import DDPMWorkload

    class Args:
        seed = SEED
        ckpt_folder = None             # a seeded init through load_params
        label_to_forget = 0
        cond_scale = COND_SCALE
        forget_alpha = FORGET_ALPHA
        method = "ron"
        unlearn_loss = "adaga"

    wl = DDPMWorkload.from_config(config)
    model = R.load_params(Args, config, wl)
    n_params = sum(p.numel() for p in model.parameters())
    print("  kernels vs plain versions at the Fisher pass's shapes",
          flush=True)
    kernel_errs = check_batch_kernels(collect_sites(model, wl.device), gen,
                                      FISHER_BATCHES, FISHER_BATCHES[1:])
    fisher_rel = fisher_batch_check(model, wl, gen)

    remain, forget = class_forget_split(R._load_train_dataset(Args, config),
                                        Args.label_to_forget)
    sizes = {"forget": len(forget), "remain": len(remain)}
    want_batches = [2 * min(TRAIN_BATCH, n - i) for n in sizes.values()
                    for i in range(0, n, TRAIN_BATCH)]
    out = tempfile.mkdtemp(prefix="uurg_fisher_")
    try:
        mask_dir = os.path.join(out, "mask_0")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with batch_clock("make_fisher_batch_step") as rec:
            _zero_launches()
            t0 = time.time()
            R.generate_fisher(Args, config, mask_dir)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = _read_launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        n_batches = len(want_batches)
        cfg_batches = [2 * b for b in rec["batch"]]
        print(f"  splits {sizes}: {len(cfg_batches)} Fisher batches of CFG "
              f"batch {cfg_batches}", flush=True)
        if cfg_batches != want_batches:
            fail(f"generate_fisher ran CFG batches {cfg_batches}, not "
                 f"{want_batches}")
        want = {k: n_batches * (n_attn if k.startswith("attention") else n_gn)
                for k in launches}
        print(f"  launches: {launches} (expected {want})", flush=True)
        if launches != want:
            fail("not every attention/GroupNorm site of the Fisher pass went "
                 "through its forward and backward kernels")
        totals = {}
        for name in ("forget", "remain"):
            f = restore_checkpoint(os.path.join(mask_dir, f"{name}_fisher"),
                                   model)
            flat = torch.cat([v.reshape(-1) for v in f.values()])
            if not (torch.isfinite(flat).all() and (flat >= 0).all()
                    and flat.max() > 0):
                fail(f"the {name} Fisher is not finite, non-negative and "
                     f"non-zero")
            totals[name] = float(flat.double().sum())
        per = np.asarray(rec["s"])
        full = per[[i for i, b in enumerate(cfg_batches)
                    if b == 2 * TRAIN_BATCH]]
        x, c = remain.get_batch(np.arange(TRAIN_BATCH))
        stream_ms, busy_ms = fisher_device_ms(
            wl, model.eval(), R._device_batch(config, x, c, wl.device))
        print(f"  {n_batches} Fisher batches: median {np.median(per) * 1e3:.3f}"
              f" ms/batch (CFG 256 only: {np.median(full) * 1e3:.3f} ms, "
              f"{1 / np.median(full):.3f} batches/s), min "
              f"{per.min() * 1e3:.3f}, max {per.max() * 1e3:.3f} ms; call "
              f"{wall:.3f} s with init and files; one CFG-256 batch: "
              f"{stream_ms:.3f} ms by CUDA events, device busy "
              f"{busy_ms:.3f} ms; peak device memory {peak_gib:.3f} GiB; "
              f"Fisher sums {totals}; on {card}", flush=True)

        masks = R.generate_fisher_mask(mask_dir, FISHER_THRESHOLDS)
        mask_sparsity = {}
        for th in FISHER_THRESHOLDS:
            back = restore_checkpoint(os.path.join(mask_dir, f"fisher_{th}"),
                                      model)
            if not all(v.dtype == torch.bool for v in back.values()) or \
                    sum(v.numel() for v in back.values()) != n_params:
                fail(f"fisher_{th}: leaves not bool or not {n_params} "
                     f"elements")
            if not all(torch.equal(back[k], v.cpu())
                       for k, v in masks[th].items()):
                fail(f"fisher_{th}: the file differs from the mask computed")
            mask_sparsity[th] = sparsity(back)
            print(f"  threshold {th}: sparsity {mask_sparsity[th]:.6f} of "
                  f"{n_params}", flush=True)

        steps_cfg = config.merged({"training": {
            "n_iters": MASKED_STEPS, "snapshot_freq": 10 ** 6,
            "log_freq": 10 ** 6}})

        def masked_steps(name, args):
            with step_clock(R) as srec:
                state = R.sfron_forget(args, steps_cfg,
                                       os.path.join(out, name))
            file_mask = restore_checkpoint(args.mask_path, model)
            if state.step != MASKED_STEPS or not all(
                    torch.equal(state.mask[k].cpu(), v)
                    for k, v in file_mask.items()):
                fail(f"{name}: {state.step} steps, or the mask held is not "
                     f"the file's")
            losses = [(float(m["forget_loss"]), float(m["remain_loss"]))
                      for m in srec["metrics"]]
            if not np.isfinite(losses).all():
                fail(f"{name}: a loss is not finite: {losses}")
            print(f"  {name}: {MASKED_STEPS} steps under "
                  f"{os.path.basename(args.mask_path)}, losses {losses}",
                  flush=True)
            return losses

        class Masked(Args):
            mask_path = os.path.join(mask_dir, "fisher_1.0")

        sfron_losses = masked_steps("sfron", Masked)

        salun_dir = os.path.join(out, "salun_mask_0")
        _zero_launches()
        R.generate_salun_mask(Args, config, salun_dir, [SALUN_RATIO])
        torch.cuda.synchronize()
        salun_launches = _read_launches()
        n_salun = -(-sizes["forget"] // TRAIN_BATCH)
        want = {k: n_salun * (n_attn if k.startswith("attention") else n_gn)
                for k in salun_launches}
        if salun_launches != want:
            fail(f"SalUn gradients: launches {salun_launches}, not {want}")
        path = os.path.join(salun_dir, f"with_{SALUN_RATIO}")
        kept = tree_count_nonzero(restore_checkpoint(path, model))
        k = int(n_params * SALUN_RATIO)
        print(f"  SalUn mask at ratio {SALUN_RATIO} over {n_salun} forget "
              f"batches (train mode; launches {salun_launches}): {kept} of "
              f"{n_params} kept, k = {k}, ties at the threshold "
              f"{kept - k}", flush=True)
        if kept < k:
            fail("the SalUn mask keeps fewer than k weights")

        class SalUn(Args):
            mask_path = path
            unlearn_loss = "rl"       # what --mode salun sets

        salun_losses = masked_steps("salun", SalUn)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return {"launches": launches, "kernel_errs": kernel_errs,
            "fisher_rel_l2": fisher_rel, "splits": sizes,
            "cfg_batches": cfg_batches, "batch_ms": (per * 1e3).tolist(),
            "median_batch_ms": float(np.median(per) * 1e3),
            "median_cfg256_batch_ms": float(np.median(full) * 1e3),
            "cfg256_batches_per_s": float(1 / np.median(full)),
            "cfg256_stream_ms": stream_ms, "cfg256_device_busy_ms": busy_ms,
            "call_seconds": wall, "peak_gib": peak_gib, "fisher_sums": totals,
            "mask_sparsity": mask_sparsity, "sfron_losses": sfron_losses,
            "salun_launches": salun_launches, "salun_kept": kept,
            "salun_k": k, "salun_losses": salun_losses}


def per_sample_grad_check(model, wl, gen, example_batch: int) -> float:
    """One example's SA Fisher gradient (batch 50: its 50 timesteps) with
    the kernels against the same model on its plain path."""
    import torch

    from uurg_torch.ops.flash_attention import attention_bwd
    from uurg_torch.ops.group_norm import group_norm_bwd

    dev = torch.device("cuda")
    x = torch.rand(32, 32, 3, generator=gen, device=dev) * 2 - 1
    c = torch.randint(0, 10, (), generator=gen, device=dev)
    ts = torch.arange(500, 500 + example_batch, device=dev)
    noise = torch.randn(example_batch, 32, 32, 3, generator=gen,
                        device=dev)
    model.eval()
    params = list(model.parameters())

    def grads():
        loss = wl.elbo_chunk_loss(model, x, c, ts, noise)
        return torch.cat([g.float().reshape(-1) for g in
                          torch.autograd.grad(loss, params)])

    bwd = (attention_bwd.launches, group_norm_bwd.launches)
    got = grads()
    if (attention_bwd.launches - bwd[0], group_norm_bwd.launches - bwd[1]) \
            == (0, 0):
        fail("the per-sample gradient did not go through the backward "
             "kernels")
    with plain_layers():
        want = grads()
    if not torch.isfinite(got).all():
        fail("the per-sample gradient with kernels is not finite")
    rel = ((got - want).norm() / want.norm()).item()
    print(f"  one example's gradient (batch {example_batch}, "
          f"{got.numel()} values), kernels vs plain path: rel L2 err "
          f"{rel:.3e} (tolerance {MODEL_GRAD_REL_L2:g})", flush=True)
    if rel > MODEL_GRAD_REL_L2:
        fail("the per-sample gradient with kernels disagrees with the plain "
             "path")
    return rel


@contextlib.contextmanager
def sa_clock(runner, ewc=None, profile_step: int | None = None):
    """Wrap the step that ``sa_forget`` builds (the runner's
    ``make_sfron_step``, forgetting off): after each step, wait for the
    device and read the clock, keep the step's loss and, with ``ewc``
    (model -> float), the EWC term after the first step; the step numbered
    ``profile_step`` is profiled for its device time instead of timed. The
    run still goes through the runner's own entry point and step."""
    import torch

    record = {"t": [], "loss": [], "ewc_after_first": None, "busy_ms": None}
    make = runner.make_sfron_step

    def timed_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(state, *batches):
            if state.step == profile_step:
                out = {}
                record["busy_ms"] = device_busy_ms(
                    "an SA step", lambda: out.update(step(state, *batches)))
                return out
            metrics = step(state, *batches)
            if ewc is not None and record["ewc_after_first"] is None:
                record["ewc_after_first"] = ewc(state.model)
            torch.cuda.synchronize()
            record["t"].append(time.perf_counter())
            record["loss"].append(float(metrics["remain_loss"]))
            return metrics

        return timed

    runner.make_sfron_step = timed_make
    try:
        yield record
    finally:
        runner.make_sfron_step = make


def sa_path(card: str, n_attn: int, n_gn: int, gen) -> dict:
    """Phase 13: the SA Fisher through ``cli/fim.py``'s function, then
    ``sa_forget`` from the file it wrote, on the full-width config."""
    import shutil

    import numpy as np
    import torch

    from uurg_torch.cli import fim
    from uurg_torch.io.checkpoint import restore_checkpoint
    from uurg_torch.workloads import ddpm_runner as R
    from uurg_torch.workloads.ddpm import DDPMWorkload, ewc_penalty

    config = sa_config()
    # an example's batch: its timesteps in chunks
    example_batch = config.diffusion.num_diffusion_timesteps // FIM_CHUNKS
    wl = DDPMWorkload.from_config(config)
    folder = tempfile.mkdtemp(prefix="uurg_sa_")

    class FimArgs:
        ckpt_folder = folder           # no ckpts/: a seeded init
        n_chunks = FIM_CHUNKS
        n_samples = FIM_SAMPLES
        batch_size = FIM_BATCH
        seed = SEED

    class Args:
        ckpt_folder = folder
        seed = SEED
        label_to_forget = 0

    try:
        model = R.load_params(Args, config, wl)
        print(f"  kernels vs plain versions at batch {example_batch}",
              flush=True)
        kernel_errs = check_batch_kernels(
            collect_sites(model, wl.device), gen, (example_batch,),
            (example_batch,))
        grad_rel = per_sample_grad_check(model, wl, gen, example_batch)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with batch_clock("make_per_sample_fisher_step") as frec:
            _zero_launches()
            t0 = time.time()
            path = fim.generate_fim(FimArgs, config)
            torch.cuda.synchronize()
            fim_wall = time.time() - t0
            fim_launches = _read_launches()
        fim_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_ex = sum(frec["batch"])
        if n_ex != FIM_CHUNKS * FIM_SAMPLES:
            fail(f"generate_fim ran {n_ex} examples, not "
                 f"{FIM_CHUNKS * FIM_SAMPLES}")
        want = {k: n_ex * (n_attn if k.startswith("attention") else n_gn)
                for k in fim_launches}
        print(f"  launches: {fim_launches} (expected {want})", flush=True)
        if fim_launches != want:
            fail("not every attention/GroupNorm site of the per-sample "
                 "Fisher went through its forward and backward kernels")
        fisher = restore_checkpoint(path, model)
        flat = torch.cat([v.reshape(-1) for v in fisher.values()])
        if not (torch.isfinite(flat).all() and (flat >= 0).all()
                and flat.max() > 0):
            fail("the SA Fisher is not finite, non-negative and non-zero")
        per_ex = np.asarray(frec["s"]) / np.asarray(frec["batch"])
        x = torch.rand(FIM_BATCH, 32, 32, 3, generator=gen,
                       device=wl.device) * 2 - 1
        c = torch.randint(0, 10, (FIM_BATCH,), generator=gen,
                          device=wl.device)
        ts = torch.arange(example_batch, device=wl.device).expand(
            FIM_BATCH, example_batch)
        zeros = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
        fim_busy = device_busy_ms(
            "a per-sample Fisher batch",
            lambda: frec["step"](zeros, model.eval(), (x, c, ts), SEED))
        fim_busy /= FIM_BATCH
        print(f"  SA Fisher: {n_ex} examples ({FIM_CHUNKS} chunks x "
              f"{FIM_SAMPLES}, batch {FIM_BATCH}), median "
              f"{np.median(per_ex) * 1e3:.3f} ms/example "
              f"({1 / np.median(per_ex):.3f} examples/s), min "
              f"{per_ex.min() * 1e3:.3f}, max {per_ex.max() * 1e3:.3f} ms; "
              f"call {fim_wall:.3f} s with init and file ("
              f"{n_ex / fim_wall:.3f} examples/s); device busy "
              f"{fim_busy:.3f} ms/example; peak device memory "
              f"{fim_peak:.3f} GiB; Fisher sum "
              f"{float(flat.double().sum()):.6e}; on {card}", flush=True)
        del fisher, flat, zeros

        warm = config.merged({"training": {
            "n_iters": SA_WARMUP_STEPS, "snapshot_freq": 10 ** 6,
            "log_freq": 10 ** 6}})
        ckpt_dir = os.path.join(folder, "sa")
        with sa_clock(R, profile_step=SA_WARMUP_STEPS - 1) as wrec:
            R.sa_forget(Args, warm, ckpt_dir)
        timed_cfg = config.merged({"training": {
            "n_iters": SA_STEPS, "snapshot_freq": 10 ** 6,
            "log_freq": 10 ** 6}})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        def ewc(sa_model):
            # the pull toward the starting weights (``model``, the same
            # seeded init that sa_forget loads) under the file's Fisher
            f = {k: v.to(wl.device)
                 for k, v in restore_checkpoint(path, model).items()}
            with torch.no_grad():
                return float(ewc_penalty(sa_model, f,
                                         dict(model.named_parameters())))

        with sa_clock(R, ewc) as rec:
            _zero_launches()
            t0 = time.time()
            state = R.sa_forget(Args, timed_cfg, ckpt_dir)
            torch.cuda.synchronize()
            sa_wall = time.time() - t0
            sa_launches = _read_launches()
        sa_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if state.step != SA_STEPS or len(rec["loss"]) != SA_STEPS:
            fail(f"sa_forget ran {len(rec['loss'])} counted steps to step "
                 f"{state.step}, not {SA_STEPS}")
        if not np.isfinite(rec["loss"]).all():
            fail(f"an SA loss is not finite: {rec['loss']}")
        if not rec["ewc_after_first"] > 0:
            fail(f"the EWC term after the first step is "
                 f"{rec['ewc_after_first']}, not above 0")
        moved = sum(not torch.equal(p, q) for p, q in
                    zip(state.model.parameters(), model.parameters()))
        ema_moved = sum(not torch.equal(p, q) for p, q in
                        zip(state.ema_model.parameters(), model.parameters()))
        n_leaves = len(list(model.parameters()))
        print(f"  {moved}/{n_leaves} parameter tensors and {ema_moved} EMA "
              f"tensors moved; EWC term after the first step "
              f"{rec['ewc_after_first']:.6e}", flush=True)
        if moved < n_leaves // 2 or ema_moved < n_leaves // 2:
            fail("the SA parameters or the EMA did not move")
        want = {k: SA_STEPS * 2 * (n_attn if k.startswith("attention")
                                   else n_gn) for k in sa_launches}
        print(f"  launches: {sa_launches} (expected {want})", flush=True)
        if sa_launches != want:
            fail("not every attention/GroupNorm site of the SA step went "
                 "through its forward and backward kernels")
        step_s = np.diff(rec["t"])
        print(f"  {SA_STEPS} SA steps (two eval-mode forwards at batch "
              f"{TRAIN_BATCH} and their backward): median "
              f"{np.median(step_s) * 1e3:.3f} ms/step "
              f"({1 / np.median(step_s):.3f} steps/s), min "
              f"{step_s.min() * 1e3:.3f}, max {step_s.max() * 1e3:.3f} ms; "
              f"call {sa_wall:.3f} s with init and ckpt.pth; device busy "
              f"{wrec['busy_ms']:.3f} ms/step (warm-up step 2, profiled); "
              f"peak device memory {sa_peak:.3f} GiB; losses "
              f"{rec['loss'][0]:.4f} -> {rec['loss'][-1]:.4f}; on {card}",
              flush=True)
        if not os.path.exists(os.path.join(ckpt_dir, "ckpt.pth")):
            fail("sa_forget wrote no ckpt.pth")
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return {"kernel_errs": kernel_errs, "grad_rel_l2": grad_rel,
            "fim_launches": fim_launches, "fim_examples": n_ex,
            "fim_example_ms": (per_ex * 1e3).tolist(),
            "fim_median_example_ms": float(np.median(per_ex) * 1e3),
            "fim_examples_per_s": float(1 / np.median(per_ex)),
            "fim_call_seconds": fim_wall, "fim_busy_ms_per_example": fim_busy,
            "fim_peak_gib": fim_peak, "sa_launches": sa_launches,
            "sa_step_ms": (step_s * 1e3).tolist(),
            "sa_median_step_ms": float(np.median(step_s) * 1e3),
            "sa_steps_per_s": float(1 / np.median(step_s)),
            "sa_call_seconds": sa_wall, "sa_busy_ms": wrec["busy_ms"],
            "sa_peak_gib": sa_peak, "sa_losses": rec["loss"],
            "ewc_after_first": rec["ewc_after_first"]}


@contextlib.contextmanager
def stage_clock(targets):
    """Wrap each ``(module, attribute, stage)`` of ``targets``: the host
    seconds of every call, between two waits for the device, summed by
    stage. The run still goes through the wrapped functions."""
    import torch

    seconds = {}
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]

    def wrap(fn, stage):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                seconds[stage] = (seconds.get(stage, 0.0)
                                  + time.perf_counter() - t0)
        return timed

    for (mod, name, stage), (_, _, fn) in zip(targets, saved):
        setattr(mod, name, wrap(fn, stage))
    try:
        yield seconds
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def model_flops(model, x) -> float:
    """Multiply-add FLOPs (2 a MAC) of the convolutions and linear layers
    in one forward of ``model`` on ``x``, counted by hooks."""
    import torch

    total = [0]

    def hook(mod, args, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.weight[0].numel()
        else:
            k = mod.in_features
        total[0] += 2 * out.numel() * k

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.inference_mode():
        model(x)
    for h in hooks:
        h.remove()
    return float(total[0])


def rel_max(name: str, got, want, tol: float) -> float:
    """max |got - want| over max |want|, on the CPU in fp32."""
    import torch

    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             f"not finite")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    print(f"  {name}: rel err {rel:.3e} (tolerance {tol:g})", flush=True)
    if rel > tol:
        fail(f"{name}: the card disagrees with the CPU")
    return rel


def eval_networks(card: str) -> dict:
    """Phase 14, first half: InceptionV3 and the ResNet-34 probe on the card
    against the same weights on the CPU, then their throughput."""
    import numpy as np
    import torch

    from uurg_torch.core.device import resolve_device
    from uurg_torch.core.rng import seeded_init_
    from uurg_torch.eval.classifier_eval import classifier_probe, resize_batch
    from uurg_torch.eval.generative import featurize
    from uurg_torch.eval.inception import (init_inception, make_extractor,
                                           preprocess)
    from uurg_torch.models.resnet import ResNet34

    dev = resolve_device("cuda")           # TF32 off, as every entry point
    rng = np.random.default_rng(SEED)
    imgs = rng.integers(0, 256, (EVAL_CHECK_BATCH, 32, 32, 3), np.uint8)
    cpu_inc = init_inception(SEED)
    want = make_extractor(cpu_inc)(imgs)
    inc = init_inception(SEED).to(dev)
    got = make_extractor(inc)(imgs)
    errs = {f"inception_{n}": rel_max(f"InceptionV3 {n} (batch "
                                      f"{EVAL_CHECK_BATCH}, 32 px -> 299)",
                                      torch.from_numpy(g),
                                      torch.from_numpy(w), EVAL_REL)
            for n, g, w in zip(("pool", "spatial", "logits"), got, want)}
    del cpu_inc
    probe_cpu = seeded_init_(ResNet34(10, imagenet_stem=True), SEED)
    probe = seeded_init_(ResNet34(10, imagenet_stem=True), SEED).to(dev)
    x224 = resize_batch(imgs, 224, "cpu")
    with torch.inference_mode():
        errs["probe_logits"] = rel_max(
            f"ResNet-34 logits (fp32, batch {EVAL_CHECK_BATCH}, 224 px)",
            probe(x224.to(dev)), probe_cpu(x224), EVAL_REL)
    del probe_cpu, probe

    # InceptionV3 throughput at batch 256: device time by CUDA events over
    # back-to-back batches already on the card, and the host clock around
    # featurize (copies both ways included)
    xb = torch.from_numpy(rng.integers(
        0, 256, (INCEPTION_BATCH, 32, 32, 3), np.uint8)).to(dev)
    flops = model_flops(inc, preprocess(xb[:1])) * INCEPTION_BATCH
    with torch.inference_mode():
        for _ in range(2):
            inc(preprocess(xb))
        torch.cuda.synchronize()
        iters = 10
        inc_ms = _events_ms(lambda: [inc(preprocess(xb))
                                     for _ in range(iters)], iters)
    many = rng.integers(0, 256, (INCEPTION_IMAGES, 32, 32, 3), np.uint8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = featurize(make_extractor(inc, materialize=False), many,
                      INCEPTION_BATCH)
    inc_host_s = time.perf_counter() - t0
    if feats[0].shape != (INCEPTION_IMAGES, 2048) or not all(
            np.isfinite(f).all() for f in feats):
        fail("featurize on the card gave bad features")
    inc_ips = INCEPTION_BATCH / (inc_ms / 1e3)
    print(f"  InceptionV3 batch {INCEPTION_BATCH} (fp32, TF32 off): "
          f"{inc_ms:.3f} ms by CUDA events, {inc_ips:.1f} images/s, "
          f"{flops / (inc_ms / 1e3) / 1e12:.2f} TFLOP/s of "
          f"{flops / INCEPTION_BATCH / 1e9:.3f} GFLOP an image "
          f"({flops / (inc_ms / 1e3) / FP32_FLOPS:.1%} of the fp32 peak); "
          f"featurize {INCEPTION_IMAGES} images on the host clock "
          f"{inc_host_s:.3f} s, {INCEPTION_IMAGES / inc_host_s:.1f} "
          f"images/s; on {card}", flush=True)
    del inc

    # the probe as the UA CLI runs it: bf16 convolutions, fp32 BatchNorm
    probe = seeded_init_(ResNet34(10, dtype=torch.bfloat16,
                                  imagenet_stem=True), SEED).to(dev)
    pb = resize_batch(many[:PROBE_BATCH], 224, dev)
    with torch.inference_mode():
        for _ in range(2):
            probe(pb)
        torch.cuda.synchronize()
        probe_ms = _events_ms(lambda: [probe(pb) for _ in range(iters)],
                              iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = classifier_probe(probe, many[:PROBE_IMAGES], 0, PROBE_BATCH,
                           224, dev)
    probe_host_s = time.perf_counter() - t0
    if res["n"] != PROBE_IMAGES or not 0 <= res["forget_accuracy"] <= 1:
        fail(f"classifier_probe on the card gave {res}")
    probe_ips = PROBE_BATCH / (probe_ms / 1e3)
    print(f"  ResNet-34 probe batch {PROBE_BATCH} at 224 px (bf16): "
          f"{probe_ms:.3f} ms by CUDA events, {probe_ips:.1f} images/s; "
          f"classifier_probe over {PROBE_IMAGES} images (resize, copies, "
          f"softmax) on the host clock {probe_host_s:.3f} s, "
          f"{PROBE_IMAGES / probe_host_s:.1f} images/s; on {card}",
          flush=True)
    return {"rel_errs": errs, "inception_batch_ms": inc_ms,
            "inception_images_per_s": inc_ips,
            "inception_gflop_per_image": flops / INCEPTION_BATCH / 1e9,
            "inception_featurize_s": inc_host_s,
            "inception_featurize_images_per_s": INCEPTION_IMAGES / inc_host_s,
            "probe_batch_ms": probe_ms, "probe_images_per_s": probe_ips,
            "probe_host_s": probe_host_s,
            "probe_host_images_per_s": PROBE_IMAGES / probe_host_s}


def parity_path(config, card: str, n_attn: int, n_gn: int) -> dict:
    """Phase 14, second half: the twin of ``cli/parity_check.py`` through
    its ``run`` at full width on the stand-in artifacts: Fisher, mask,
    SFR-on, sampling, metrics, with exact launch counts."""
    import shutil
    import types

    import numpy as np
    import scipy.linalg
    import torch

    from uurg_torch.cli import parity_check as P
    from uurg_torch.data.splits import class_forget_split
    from uurg_torch.eval import classifier_eval as CE
    from uurg_torch.eval import generative as G
    from uurg_torch.workloads import ddpm_runner as R

    cfg = config.merged({"training": {"n_iters": PARITY_ITERS}})
    work = tempfile.mkdtemp(prefix="uurg_parity_")
    args = types.SimpleNamespace(
        artifacts=os.path.join(work, "artifacts"), out=os.path.join(
            work, "out"), label_to_forget=0, forget_alpha=1e-4,
        mask_threshold=1.0, n_samples=PARITY_SAMPLES, n_probe=PARITY_PROBE,
        sample_steps=DDIM_STEPS, quick=False, skip_fisher=False,
        pack_mask=False, nu_dtype="f32", remat=False, seed=1234)
    # what the run should launch: one forward and backward of every site a
    # Fisher batch (the stand-in's splits at the training batch, the ragged
    # last batch kept), two a SFR-on step, one forward a sampling step
    remain, forget = class_forget_split(R._load_train_dataset(
        args, cfg.merged({"data": {"path": args.artifacts}})), 0)
    bs = cfg.training.batch_size
    n_fisher = sum(-(-len(s) // bs) for s in (forget, remain))
    n_sample = sum(-(-n // cfg.sampling.batch_size)
                   for n in (PARITY_SAMPLES, PARITY_PROBE)) * DDIM_STEPS
    fwd = n_fisher + 2 * PARITY_ITERS + n_sample
    bwd = n_fisher + 2 * PARITY_ITERS
    want = {"attention_fwd": fwd * n_attn, "attention_bwd": bwd * n_attn,
            "group_norm_fwd": fwd * n_gn, "group_norm_bwd": bwd * n_gn}
    stages = [(R, "generate_fisher", "fisher"),
              (R, "generate_fisher_mask", "mask"),
              (R, "sfron_forget", "sfron"), (R, "sample_images", "sampling"),
              (G, "featurize", "featurize"), (G, "compute_fid", "frechet"),
              (scipy.linalg, "sqrtm", "sqrtm"),
              (G, "precision_recall", "precision_recall"),
              (G, "inception_score", "inception_score"),
              (CE, "classifier_probe", "probe")]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with stage_clock(stages) as seconds:
            _zero_launches()
            t0 = time.time()
            report = P.run(args, cfg, "cuda")
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = _read_launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  launches: {launches} (expected {want}: {n_fisher} Fisher "
              f"batches, {PARITY_ITERS} SFR-on steps, {n_sample} sampling "
              f"UNet calls)", flush=True)
        if launches != want:
            fail("not every attention/GroupNorm site of the five stages went "
                 "through its kernels")
        m = report["metrics"]
        print(f"  metrics: {json.dumps(m)}", flush=True)
        if not all(np.isfinite(m[k]) for k in P.BANDS):
            fail(f"a metric is not finite: {m}")
        if not all(0.0 <= m[k] <= 1.0 for k in
                   ("precision", "recall", "forget_accuracy")):
            fail(f"precision, recall or UA outside [0, 1]: {m}")
        if m["inception_score"] < 1.0:
            fail(f"IS {m['inception_score']} below 1")
        if report["real_run"] or not all(
                r["status"].startswith("SKIPPED") for r in report["report"]):
            fail(f"a band is not SKIPPED on stand-ins: {report['report']}")
        with open(os.path.join(args.out, "parity_report.json")) as f:
            if json.load(f)["report"] != report["report"]:
                fail("parity_report.json differs from the report returned")
        for name, n in (("samples.npz", PARITY_SAMPLES),
                        ("probe_samples.npz", PARITY_PROBE)):
            arr = np.load(os.path.join(args.out, name))["arr_0"]
            if arr.shape != (n, 32, 32, 3) or arr.dtype != np.uint8:
                fail(f"{name}: {arr.shape} {arr.dtype}, not ({n}, 32, 32, 3)"
                     f" uint8")
        timed = ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        print(f"  the five stages at full width: {wall:.3f} s on the host "
              f"clock; by stage (s, host clock between waits for the "
              f"device): {timed}; references {len(remain)}; peak device "
              f"memory {peak_gib:.3f} GiB; on {card}", flush=True)
        for r in report["report"]:
            print(f"  {r['metric']:<22}{r['value']:>10}  {r['band']:<12}"
                  f"{r['status']}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"launches": launches, "expected": want, "wall_s": wall,
            "stage_s": seconds, "peak_gib": peak_gib, "metrics": m,
            "fisher_batches": n_fisher, "sampling_unet_calls": n_sample,
            "references": len(remain)}


# a CLI process of the pipeline: imports torch and the CLI's modules at
# once, reads its arguments (a JSON list) from its standard input when the
# stage before it has written what it reads, then runs ``python -m <module>
# ARGS`` as ``-m`` does (runpy, with sys.argv and __main__ set) and writes
# the kernel counters of uurg_torch/ops to OUT
_STAGED_MAIN = """
import importlib, json, runpy, sys
out, mod, warm = sys.argv[1], sys.argv[2], sys.argv[3:]
for m in warm:
    if m != mod:
        importlib.import_module(m)
sys.argv = [mod] + json.loads(sys.stdin.readline())
runpy.run_module(mod, run_name="__main__", alter_sys=True)
from uurg_torch.ops.flash_attention import attention, attention_bwd
from uurg_torch.ops.group_norm import group_norm, group_norm_bwd
with open(out, "w") as f:
    json.dump({"attention_fwd": attention.launches,
               "attention_bwd": attention_bwd.launches,
               "group_norm_fwd": group_norm.launches,
               "group_norm_bwd": group_norm_bwd.launches}, f)
"""


# the modules the pipeline's CLIs import, compiled once into the shared
# bytecode cache while the kernels build
_WARM_IMPORTS = ("torch", "scipy.linalg", "PIL.Image",
                 "uurg_torch.workloads.ddpm_runner", "uurg_torch.cli.train",
                 "uurg_torch.cli.sample", "uurg_torch.cli.evaluator",
                 "uurg_torch.cli.classifier_evaluation",
                 "uurg_torch.cli.train_classifier",
                 "uurg_torch.cli.save_base_dataset",
                 "uurg_torch.eval.generative", "uurg_torch.eval.inception",
                 "uurg_torch.eval.classifier_eval", "uurg_torch.models",
                 "uurg_torch.utils.images", "uurg_torch.utils.profiling")
PYCACHE = os.path.join(tempfile.gettempdir(), f"uurg_pycache_{os.getpid()}")


def cli_env() -> dict:
    """The environment of the CLI processes: this checkout first on the
    path, and one bytecode cache (PYCACHE) that they share: the card's
    machine keeps none for its packages (PYTHONDONTWRITEBYTECODE), and an
    ``import torch`` there took 10.5 s filling the cache and 4.3-5.1 s from
    it (scripts/profile_torch_cli_startup.py)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), PYTHONPYCACHEPREFIX=PYCACHE)
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    return env


def bytecode_warmup() -> subprocess.Popen:
    """Start a process that imports _WARM_IMPORTS into PYCACHE (removed at
    exit), so that the pipeline's first processes find it filled."""
    import atexit
    import shutil

    atexit.register(shutil.rmtree, PYCACHE, True)
    proc = subprocess.Popen(
        [sys.executable, "-c", "import importlib, sys\n"
         "for m in sys.argv[1:]: importlib.import_module(m)",
         *_WARM_IMPORTS], env=cli_env(), cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    atexit.register(proc.kill)       # a run that fails before phase 14b
    return proc


def cli_stage(name: str, work: str, threads: int | None = None
              ) -> subprocess.Popen:
    """Start the process of ``python -m uurg_torch.cli.<name>`` in ``work``
    (no ./data there: the CLIs take the stand-in) in :func:`cli_env`: it
    imports torch and _WARM_IMPORTS now, and runs the CLI once
    :func:`cli_go` hands it its arguments; it then writes its kernel
    launches to ``<log>.launches.json``. Its output goes to a log of its
    own under ``work``. ``threads`` caps its host threads (BLAS, OpenMP)."""
    n = len([f for f in os.listdir(work) if f.endswith(".log")])
    log = open(os.path.join(work, f"{n:02d}_{name}.log"), "w")
    env = cli_env()
    if threads:
        env.update({v: str(threads) for v in (
            "OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")})
    proc = subprocess.Popen(
        [sys.executable, "-c", _STAGED_MAIN, log.name + ".launches.json",
         f"uurg_torch.cli.{name}", *_WARM_IMPORTS], cwd=work, env=env,
        stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT,
        text=True)
    proc.name, proc.log, proc.t0 = name, log, None
    return proc


def cli_go(proc: subprocess.Popen, args: list[str]) -> subprocess.Popen:
    """Hand a process of :func:`cli_stage` its arguments: the CLI starts."""
    proc.t0 = time.time()
    try:
        proc.stdin.write(json.dumps(args) + "\n")
        proc.stdin.close()
    except BrokenPipeError:
        pass                    # it died while importing: cli_wait says why
    return proc


def cli_wait(proc: subprocess.Popen) -> tuple[float, str, dict]:
    """Wait for a process of :func:`cli_stage`; fails unless it exits 0.
    Returns (seconds from its arguments to its exit, its output, its
    kernel launches)."""
    try:
        rc = proc.wait(timeout=PIPE_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed at the time limit"
    secs = time.time() - proc.t0
    proc.log.close()
    with open(proc.log.name) as f:
        text = f.read()
    if rc != 0:
        fail(f"python -m uurg_torch.cli.{proc.name} exited {rc}:\n"
             f"{text[-3000:]}")
    last = text.strip().splitlines()[-1] if text.strip() else ""
    print(f"  python -m uurg_torch.cli.{proc.name}: exit 0 in {secs:.1f} s "
          f"[at {time.time() - STARTED:.1f} s]; {last[:200]}", flush=True)
    return secs, text, _json(proc.log.name + ".launches.json")


def run_dir_of(text: str) -> str:
    """The run directory that ``uurg_torch.cli.train`` prints last."""
    lines = [ln for ln in text.splitlines() if ln.startswith("done: ")]
    if not lines:
        fail("the trainer CLI printed no run directory")
    return lines[-1][len("done: "):].strip()


def _ckpt_tensors(obj, prefix: str = "") -> dict:
    """Every tensor of a checkpoint (nested lists and dicts), by path."""
    import torch

    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    items = (obj.items() if isinstance(obj, dict) else enumerate(obj)
             if isinstance(obj, (list, tuple)) else ())
    out = {}
    for k, v in items:
        out.update(_ckpt_tensors(v, f"{prefix}/{k}"))
    return out


def _cli_chain(work: str, common: list[str], state: dict,
               fisher_done: threading.Event) -> dict:
    """The pipeline's processes in order (run on a thread of its own):
    pretrain, generate_fisher (``state["sfron_argv"]`` is set and
    ``fisher_done`` signalled once its mask is written), sfron beside
    train_classifier and save_base_dataset, sample, then the evaluator and
    classifier_evaluation, which are started and returned running (their
    host work, the Fréchet distance's ``sqrtm``, on EVAL_THREADS threads
    beside the script's next phases). Each process starts (and imports
    torch) while the stage before it runs, and gets its arguments when that
    stage has exited. Returns the run directories, seconds, the DDPM
    processes' launches and the two running processes."""
    none = os.path.join(work, "no_data")
    seconds, launches, procs = {}, {}, []

    def stage(name, threads=None):
        procs.append(cli_stage(name, work, threads))
        return procs[-1]

    ok = False
    try:
        pre = cli_go(stage("train"), common + [
            "--mode", "pretrain", "--n_iters", str(PIPE_ITERS)])
        nxt = stage("train")
        seconds["pretrain"], text, launches["pretrain"] = cli_wait(pre)
        pre = run_dir_of(text)
        fisher = cli_go(nxt, common + [
            "--mode", "generate_fisher", "--ckpt_folder", pre, "--threshold",
            "1.0"])
        nxt = stage("train")
        seconds["generate_fisher"], _, launches["generate_fisher"] = \
            cli_wait(fisher)
        state["sfron_argv"] = sfron_argv = common + [
            "--mode", "sfron", "--ckpt_folder", pre, "--forget_alpha",
            "10.0", "--decay_forget_alpha", "--remain_alpha", "1.0",
            "--method", "ron", "--unlearn_loss", "adaga", "--mask_path",
            os.path.join(pre, "mask_0", "fisher_1.0"), "--n_iters",
            str(PIPE_ITERS)]
        fisher_done.set()
        sfron = cli_go(nxt, sfron_argv)
        # the probe and the references need no DDPM run: beside sfron
        side = [cli_go(stage("train_classifier"), [
                    "--data_path", none, "--epochs", "1", "--batch_size",
                    str(PIPE_PROBE_BATCH), "--image_size",
                    str(PIPE_PROBE_RES), "--save_path",
                    os.path.join(work, "probe")]),
                cli_go(stage("save_base_dataset"), [
                    "--data_path", none, "--label_to_forget", "0",
                    "--as_npz", "--out", os.path.join(work, "ref")])]
        nxt = stage("sample")
        seconds["sfron"], text, launches["sfron"] = cli_wait(sfron)
        forget = run_dir_of(text)
        samples = os.path.join(work, "samples")
        sample = cli_go(nxt, [
            "--config", SFRON_YML, "--mode", "sample_fid", "--ckpt_folder",
            forget, "--n_samples_per_class", str(PIPE_SAMPLES),
            "--classes_to_generate", "x0", "--seed", str(SEED), "--out",
            samples])
        evals = [stage("evaluator", EVAL_THREADS),
                 stage("classifier_evaluation", EVAL_THREADS)]
        for proc in side:
            seconds[proc.name] = cli_wait(proc)[0]
        seconds["sample"], _, launches["sample"] = cli_wait(sample)
        cli_go(evals[0], [os.path.join(work, "ref.npz"), samples, "--csv",
                          os.path.join(work, "eval.csv")])
        cli_go(evals[1], [samples, "--classifier_ckpt", os.path.join(
                              work, "probe", "cifar10_resnet34.pth"),
                          "--label_of_forgotten_class", "0", "--image_size",
                          str(PIPE_PROBE_RES), "--csv",
                          os.path.join(work, "ua.csv")])
        ok = True
    finally:
        for proc in procs:              # what a failure left running
            if not ok and proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"forget": forget, "samples": samples, "seconds": seconds,
            "launches": launches, "evals": evals}


def pipeline_path(card: str, n_attn: int, n_gn: int, warmup=None,
                  alongside=None) -> tuple[dict, object, object]:
    """The north-star pipeline through the port's CLIs, each a process of
    its own reading the files the one before it wrote (README.md's
    commands): train --mode pretrain, --mode generate_fisher, --mode sfron
    with the Fisher mask, sample --mode sample_fid on the forget run, the
    evaluator on those samples against save_base_dataset's references, and
    classifier_evaluation with a probe from train_classifier. The SFR-on
    process's checkpoint is held bit for bit to sfron_forget run in this
    process from the same pretrain checkpoint, mask, config and seed, and
    the DDPM processes' kernel launches are read back and checked
    (``n_attn`` and ``n_gn`` sites a UNet pass). The processes are driven
    from a thread while this one runs ``alongside()`` (the twin of
    cli/parity_check.py: its launch counters are this process's own) and
    then the in-process SFR-on run. ``warmup`` is :func:`bytecode_warmup`'s
    process, waited for first. Returns (this phase's record, ``alongside()``'s
    result, ``finish``): the evaluator and classifier_evaluation run on
    after this returns, and ``finish()`` waits for them, checks what they
    wrote into the record and removes the phase's files (at exit if it is
    not called)."""
    import atexit
    import csv
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from uurg_torch.cli import train as train_cli
    from uurg_torch.data.splits import class_forget_split
    from uurg_torch.workloads import ddpm_runner as R

    _collect()
    if warmup is not None:
        warmup.wait(timeout=PIPE_TIMEOUT)
    work = tempfile.mkdtemp(prefix="uurg_pipeline_")
    common = ["--config", SFRON_YML, "--exp", os.path.join(work, "exp"),
              "--label_to_forget", "0", "--seed", str(SEED)]
    state, fisher_done, evals = {}, threading.Event(), []

    def cleanup():
        for proc in evals:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)

    atexit.register(cleanup)
    with ThreadPoolExecutor(1) as pool:
        chain = pool.submit(_cli_chain, work, common, state, fisher_done)
        beside = alongside() if alongside is not None else None
        # the same SFR-on run in this process, once the mask is written
        while not fisher_done.wait(1.0):
            if chain.done():
                chain.result()          # the chain failed before it
        args = train_cli.parse_args(state["sfron_argv"])
        config = sfron_config()
        config.training.n_iters = PIPE_ITERS
        twin = sfron_twin(args, config, os.path.join(work, "twin"))
        run = chain.result()
    evals += run["evals"]
    seconds, launches = run["seconds"], run["launches"]
    seconds["sfron_in_process"] = twin["seconds"]
    got = _ckpt_tensors(torch.load(
        os.path.join(run["forget"], "ckpts", "ckpt.pth"),
        map_location="cpu", weights_only=True))
    want = twin["tensors"]
    if set(got) != set(want) or len(got) < 100:
        fail(f"the SFR-on CLI's checkpoint holds other tensors than the "
             f"in-process run's ({len(got)} and {len(want)})")
    differ = [k for k in got if not torch.equal(got[k], want[k])]
    print(f"  sfron CLI checkpoint vs in-process sfron_forget: "
          f"{len(got) - len(differ)} of {len(got)} tensors bit-equal",
          flush=True)
    spread = None
    if differ:
        # not bit-equal: gate within SCAN_SPREAD times the spread of two
        # in-process runs of the same inputs
        again = sfron_twin(args, config, os.path.join(work, "twin2"))
        spread = _ckpt_gap(again["tensors"], want)
        gap = _ckpt_gap(got, want)
        print(f"  not bit-equal at {len(differ)} tensors ({differ[:3]}): "
              f"relative L2 {gap:.3e} against two in-process runs' "
              f"{spread:.3e}", flush=True)
        if not gap <= SCAN_SPREAD * spread:
            fail("the SFR-on CLI's checkpoint differs from the in-process "
                 "run's beyond their own spread")
    pngs = sorted(f for f in os.listdir(run["samples"]) if f.endswith(".png"))
    if len(pngs) != 9 * PIPE_SAMPLES:
        fail(f"sample wrote {len(pngs)} PNG files, not {9 * PIPE_SAMPLES}")

    # a forward and a backward a Fisher batch (the stand-in's splits at the
    # training batch, the ragged last kept), one of each a pretrain step,
    # two a SFR-on step, one forward a DDIM step of the one sampling batch
    remain, forget_split = class_forget_split(R._load_train_dataset(
        args, config.merged({"data": {"path": os.path.join(
            work, "no_data")}})), 0)
    bs = config.training.batch_size
    n_fisher = sum(-(-len(x) // bs) for x in (forget_split, remain))
    want_launches = {
        "generate_fisher": _pass_launches(n_fisher, n_fisher, n_attn, n_gn),
        "pretrain": _pass_launches(PIPE_ITERS, PIPE_ITERS, n_attn, n_gn),
        "sfron": _pass_launches(2 * PIPE_ITERS, 2 * PIPE_ITERS, n_attn,
                                n_gn),
        "sample": _pass_launches(DDIM_STEPS, 0, n_attn, n_gn)}
    print(f"  launches by process: {json.dumps(launches)}", flush=True)
    for name, want_l in want_launches.items():
        if launches[name] != want_l:
            fail(f"the {name} process launched {launches[name]}, not "
                 f"{want_l}")
    record = {"seconds": seconds, "launches": launches,
              "expected": want_launches, "sfron_bit_equal": not differ,
              "sfron_differ": len(differ), "sfron_spread": spread,
              "samples": len(pngs)}

    def finish() -> None:
        print(f"  phase 14b's evaluator and classifier_evaluation, begun at "
              f"{evals[0].t0 - STARTED:.1f} s:", flush=True)
        for proc in evals:
            seconds[proc.name] = cli_wait(proc)[0]
        with open(os.path.join(work, "eval.csv")) as f:
            metrics = list(csv.DictReader(f))
        with open(os.path.join(work, "ua.csv")) as f:
            ua = list(csv.DictReader(f))
        keys = ("inception_score", "fid", "sfid", "precision", "recall")
        if len(metrics) != 1 or not all(
                np.isfinite(float(metrics[0][k])) for k in keys):
            fail(f"the evaluator wrote {metrics}")
        if len(ua) != 1 or not 0.0 <= float(ua[0]["forget_accuracy"]) <= 1:
            fail(f"classifier_evaluation wrote {ua}")
        record.update(metrics=metrics[0], ua=ua[0])
        print(f"  evaluator row {json.dumps({k: metrics[0][k] for k in keys})}"
              f"; UA row {json.dumps(ua[0])}; seconds "
              f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})}; "
              f"on {card}", flush=True)
        cleanup()

    return record, beside, finish


def sfron_twin(args, config, ckpt_dir: str) -> dict:
    """``sfron_forget`` in this process as the SFR-on CLI runs it (PyTorch's
    default TF32 settings, which earlier phases change): its seconds and
    its checkpoint's tensors."""
    import torch

    from uurg_torch.workloads import ddpm_runner as R

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.time()
        R.sfron_forget(args, config, ckpt_dir, device="cuda")
        torch.cuda.synchronize()
        secs = time.time() - t0
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    tensors = _ckpt_tensors(torch.load(
        os.path.join(ckpt_dir, "ckpt.pth"), map_location="cpu",
        weights_only=True))
    _collect()
    return {"seconds": secs, "tensors": tensors}


def _ckpt_gap(got: dict, want: dict) -> float:
    """Relative L2 of the floating tensors of two checkpoints, all of them
    concatenated."""
    import torch

    keys = [k for k in want if want[k].is_floating_point()]
    a = torch.cat([got[k].double().reshape(-1) for k in keys])
    b = torch.cat([want[k].double().reshape(-1) for k in keys])
    return ((a - b).norm() / b.norm()).item()


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _pass_launches(fwd: int, bwd: int, n_attn: int, n_gn: int) -> dict:
    return {"attention_fwd": fwd * n_attn, "attention_bwd": bwd * n_attn,
            "group_norm_fwd": fwd * n_gn, "group_norm_bwd": bwd * n_gn}


@contextlib.contextmanager
def cls_clock(module, profile_from: int, n_profiled: int):
    """Wrap the SFR-on step that ``module.make_sfron_step`` builds: steps
    ``profile_from`` to ``profile_from + n_profiled - 1`` run under the
    profiler (their device time summed), every other step is followed by a
    wait for the device and a read of the clock; the losses are kept. The
    run still goes through the method's own step."""
    import torch

    record = {"t": [], "loss": [], "busy_ms": 0.0}
    make = module.make_sfron_step

    def timed_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(state, *batches):
            out = {}
            if profile_from <= state.step < profile_from + n_profiled:
                record["busy_ms"] += device_busy_ms(
                    "an SFR-on iteration",
                    lambda: out.update(step(state, *batches)))
            else:
                out = step(state, *batches)
                torch.cuda.synchronize()
                record["t"].append(time.perf_counter())
            record["loss"].append((float(out["forget_loss"]),
                                   float(out["remain_loss"])))
            return out

        return timed

    module.make_sfron_step = timed_make
    try:
        yield record
    finally:
        module.make_sfron_step = make


def _scan_tensors(state) -> dict:
    """Every tensor an SFR-on chunk moves, by group: parameters, buffers
    (the BatchNorm statistics), gradients, optimizer state (learning rates
    included)."""
    import torch

    params = list(state.model.parameters())
    opt = [v for st in state.optimizer.state.values() for v in st.values()
           if torch.is_tensor(v)]
    return {"parameters": params, "buffers": list(state.model.buffers()),
            "gradients": [p.grad for p in params],
            "optimizer": opt + [g["lr"] for g in
                                state.optimizer.param_groups]}


def _scan_gap(got: list, want: list) -> float:
    """Relative L2 distance of two lists of tensors, concatenated."""
    import torch

    a = torch.cat([t.detach().double().reshape(-1) for t in got])
    b = torch.cat([t.detach().double().reshape(-1) for t in want])
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def scan_compare(scan, state, f, r, gen, counters) -> dict:
    """One chunk through the scan's graph replay and through its plain
    loop from the same state (the generator is seeded from the state's
    step by both): parameters, buffers, gradients, optimizer state and the
    losses compared. The state is left as the plain loop leaves it; the
    plain loops' counts (launches, forwards) are returned to be taken out
    of the path's, with the replay's metrics."""
    import torch

    groups = _scan_tensors(state)
    tensors = [t for ts in groups.values() for t in ts]
    start = [t.detach().clone() for t in tensors]
    step0 = state.step
    graph_m = {k: v.clone() for k, v in scan(state, f, r, gen).items()}
    torch.cuda.synchronize()
    graph_t = [t.detach().clone() for t in tensors]

    def plain():
        with torch.no_grad():
            for t, s0 in zip(tensors, start):
                t.copy_(s0)
        state.step = step0
        before = counters()
        m = scan.plain(state, f, r, gen)
        torch.cuda.synchronize()
        after = counters()
        return m, {k: after[k] - before[k] for k in after}

    plain_m, delta = plain()
    losses = [torch.stack([m["forget_loss"], m["remain_loss"]])
              for m in (graph_m, plain_m)]
    equal = (all(torch.equal(a, b) for a, b in zip(graph_t, tensors))
             and torch.equal(*losses))
    by_group, i = {}, 0
    for name, ts in groups.items():
        if ts:
            by_group[name] = _scan_gap(graph_t[i:i + len(ts)],
                                       tensors[i:i + len(ts)])
        i += len(ts)
    out = {"bit_equal": equal, "rel_l2": _scan_gap(graph_t, tensors),
           "rel_l2_by_group": by_group,
           "loss_rel_l2": _scan_gap(losses[:1], losses[1:]),
           "plain_counts": delta, "spread": None}
    if not equal:
        # the plain loop's own run-to-run spread: run it once more
        first = [t.detach().clone() for t in tensors]
        _, again = plain()
        delta = {k: delta[k] + again[k] for k in delta}
        out.update(spread=_scan_gap(first, tensors), plain_counts=delta)
    return out, graph_m


@contextlib.contextmanager
def scan_clock(module, counters, chunks: int):
    """Wrap the SFR-on scan that ``module.make_sfron_scan`` builds; the run
    still goes through the method's own scan and state. Every chunk ends
    with a wait for the device and a read of the clock; chunk
    SCAN_COMPARED goes through :func:`scan_compare`, chunk SCAN_PROFILED
    runs under the profiler (its device time), unless it is the last.
    ``counters()`` reads the counts to follow (launches, forwards): read at
    the first chunk and around each capture, whose counts a replay repeats
    with no Python (``effective`` adds them once a replay after the
    first)."""
    import torch

    rec = {"t": [], "loss": [], "busy_ms": None, "compare": None,
           "captured": {}, "scans": [], "at_first_chunk": None}
    make = module.make_sfron_scan

    def timed_make(*args, **kwargs):
        scan = make(*args, **kwargs)
        rec["scans"].append(scan)
        capture = scan._capture

        def counted(state, generator, pattern):
            before = counters()
            out = capture(state, generator, pattern)
            after = counters()
            rec["captured"][pattern] = {k: after[k] - before[k]
                                        for k in after}
            return out

        scan._capture = counted

        def run(state, f, r, gen):
            i = len(rec["t"])
            if i == 0:
                rec["at_first_chunk"] = counters()
            out = {}
            if i == SCAN_COMPARED:
                rec["compare"], out = scan_compare(scan, state, f, r, gen,
                                                   counters)
            elif i == SCAN_PROFILED and i < chunks - 1:
                rec["busy_ms"] = device_busy_ms(
                    "an SFR-on chunk", lambda: out.update(
                        scan(state, f, r, gen)))
            else:
                out = scan(state, f, r, gen)
            torch.cuda.synchronize()
            rec["t"].append(time.perf_counter())
            rec["loss"] += list(zip(out["forget_loss"].tolist(),
                                    out["remain_loss"].tolist()))
            return out

        return run

    module.make_sfron_scan = timed_make
    try:
        yield rec
    finally:
        module.make_sfron_scan = make


def effective(raw: dict, rec: dict) -> dict:
    """The counts a scan's run made on the device: the counters' readings
    less the compared plain loops', plus each graph's captured counts once
    more for every replay after its first (capture ran the Python once)."""
    scan = rec["scans"][-1]
    plain = (rec["compare"] or {}).get("plain_counts", {})
    out = {k: v - plain.get(k, 0) for k, v in raw.items()}
    for pattern, counts in rec["captured"].items():
        for k, v in counts.items():
            out[k] += v * (scan.replays.get(pattern, 0) - 1)
    return out


def scan_summary(tag: str, rec: dict, chunk: int, card: str) -> dict:
    """Host ms an iteration over the timed chunks, the profiled chunk's
    device ms an iteration, the graph-against-plain result (a fault fails
    the run)."""
    import numpy as np

    cmp_ = rec["compare"]
    if cmp_ is None:
        fail(f"{tag}: no chunk was held against the plain loop")
    scan = rec["scans"][-1]
    if not scan.replays or not rec["captured"]:
        fail(f"{tag}: no CUDA graph was captured and replayed")
    spread = cmp_["spread"]
    ok = cmp_["bit_equal"] or (spread is not None and spread > 0 and
                               cmp_["rel_l2"] <= SCAN_SPREAD * spread)
    print(f"  {tag}: graph replay against the plain chunk loop ({chunk} "
          f"iterations from one state and seed): "
          f"{'bit-equal' if cmp_['bit_equal'] else 'not bit-equal'} "
          f"(state rel L2 {cmp_['rel_l2']:.3e}: "
          + ", ".join(f"{k} {v:.3e}"
                      for k, v in cmp_["rel_l2_by_group"].items())
          + f"; losses {cmp_['loss_rel_l2']:.3e}"
          + (f", the plain loop's own spread {spread:.3e}, gate "
             f"{SCAN_SPREAD} times it" if spread is not None else "")
          + f"); graphs {len(rec['captured'])}, replays "
          f"{sum(scan.replays.values())}", flush=True)
    if not ok:
        fail(f"{tag}: the CUDA graph's chunk disagrees with its plain loop")
    t = np.asarray(rec["t"])
    timed = [k for k in range(SCAN_PROFILED + 1, len(t))]
    dt = (np.asarray([t[k] - t[k - 1] for k in timed]) / chunk
          if timed else np.asarray([]))
    busy = None if rec["busy_ms"] is None else rec["busy_ms"] / chunk
    out = {"chunk": chunk, "chunks": len(t), "compare": cmp_,
           "graphs": len(rec["captured"]),
           "replays": sum(scan.replays.values()),
           "iter_ms": (dt * 1e3).tolist(),
           "mean_iter_ms": float(dt.mean() * 1e3) if len(dt) else None,
           "busy_ms_per_iter": busy,
           "busy_share": (float(busy / 1e3 / dt.mean())
                          if busy is not None and len(dt) else None)}
    if len(dt):
        print(f"  {tag} chunked: {out['mean_iter_ms']:.3f} ms an iteration "
              f"on the host clock ({1e3 / out['mean_iter_ms']:.2f} it/s) "
              f"over {len(dt)} timed chunks of {chunk}; device busy "
              f"{busy:.3f} ms an iteration (profiler, one replayed chunk), "
              f"{out['busy_share']:.1%} of the host's; on {card}",
              flush=True)
    return out


def _cls_model(dtype, dev, seed: int = SEED):
    import torch

    from uurg_torch.models import create_model, init_classifier

    return init_classifier(torch.Generator().manual_seed(seed),
                           create_model("ResNet18", 10, dtype=dtype)).to(dev)


def _moved(model, before: dict) -> tuple[float, float]:
    """(max |change| of the parameters, of the running statistics)."""
    sd = model.state_dict()

    def biggest(pick):
        return max(float((sd[k].float() - v.float()).abs().max())
                   for k, v in before.items() if pick(k))

    return (biggest(lambda k: "running" not in k and "num_batches" not in k),
            biggest(lambda k: "running" in k))


def cls_card_vs_cpu(dev) -> dict:
    """Phase 15, first part: one train-mode CE step through SGD at batch 16
    on the card and on the CPU from the same weights, in fp32 (TF32 off)
    and in float64; the fp32 gradients' distance from float64 on each."""
    import numpy as np
    import torch

    import torch.nn.functional as F

    from uurg_torch.models import create_model, init_classifier
    from uurg_torch.train.optim import make_optimizer
    from uurg_torch.workloads.classification import Classifier

    rng = np.random.default_rng(SEED)
    x = rng.random((CLS_CHECK_BATCH, 32, 32, 3), dtype=np.float32)
    y = rng.integers(0, 10, CLS_CHECK_BATCH)
    out = {}
    for dtype in (torch.float32, torch.float64):
        for where in ("cpu", dev):
            model = init_classifier(
                torch.Generator().manual_seed(SEED),
                create_model("ResNet18", 10, dtype=dtype)).to(where, dtype)
            cls = Classifier(torch.device(where))
            opt = make_optimizer("sgd", model.parameters(), 0.1,
                                 momentum=0.9, weight_decay=5e-4)
            xb, yb = cls.batch(x, y)
            logits = cls.train_apply(model, xb)
            loss = F.cross_entropy(logits, yb)     # in the logits' dtype
            loss.backward()
            grads = torch.cat([p.grad.reshape(-1)
                               for p in model.parameters()])
            with torch.no_grad():            # the moved statistics, before
                eval_logits = cls.eval_apply(model, xb)  # the step
            opt.step()
            sd = model.state_dict()
            out[dtype, str(where)] = {
                "logits": logits, "loss": loss.reshape(1),
                "gradients": grads,
                "parameters after the step": torch.cat(
                    [p.detach().reshape(-1) for p in model.parameters()]),
                "running mean": torch.cat([v.reshape(-1) for k, v in
                                           sd.items()
                                           if k.endswith("running_mean")]),
                "running var": torch.cat([v.reshape(-1) for k, v in
                                          sd.items()
                                          if k.endswith("running_var")]),
                "eval-mode logits": eval_logits}
    errs = {}
    for dtype, tol in ((torch.float32, CLS_REL), (torch.float64, CLS_F64_REL)):
        name = str(dtype).removeprefix("torch.")
        for k, v in out[dtype, str(dev)].items():
            t = CLS_GRAD_REL if k == "gradients" and name == "float32" else tol
            errs[f"{name} {k}"] = rel_l2(
                f"ResNet-18 {k} ({name}, card vs CPU, batch "
                f"{CLS_CHECK_BATCH})", v, out[dtype, "cpu"][k], t, "the CPU")
    ref = out[torch.float64, "cpu"]["gradients"].cpu()
    for where in ("cpu", str(dev)):
        g = out[torch.float32, where]["gradients"].detach().cpu().double()
        gap = ((g - ref).norm() / ref.norm()).item()
        errs[f"float32 gradients on {where} vs float64"] = gap
        print(f"  float32 gradients on {where} against float64 on the CPU: "
              f"rel L2 {gap:.3e}", flush=True)
    return errs


def cls_sfron(dtype, data, dev, card: str, n_iters: int,
              scan_chunk: int | None = None, mask: bool = True,
              save_path: str | None = None) -> dict:
    """Phase 15: ``SFRon`` through the registry on the stand-in at
    ``dtype``: the Fisher pass and the mask (unless ``mask`` is off; the
    two Fishers read from ``save_path`` where an earlier run of the same
    model left them), ``n_iters`` iterations. Chunked (``scan_chunk``
    None: the method's default, cut to divide ``n_iters``) under
    :func:`scan_clock`; ``scan_chunk`` 1 step by step under
    :func:`cls_clock`, CLS_WARMUP of them untimed (CLS_PROFILED of those
    profiled)."""
    import numpy as np
    import torch

    from uurg_torch.data.arrays import epoch_batches
    from uurg_torch.unlearn.methods import classification as TM
    from uurg_torch.workloads.classification import Classifier

    retain, forget, test, aug = data
    model = _cls_model(dtype, dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    overrides = {"n_iters": n_iters, "mask": mask}
    if scan_chunk is not None:
        overrides["scan_chunk"] = scan_chunk
    chunk = CLS_SCAN_CHUNK if scan_chunk is None else scan_chunk
    while chunk > 1 and n_iters % chunk:
        chunk -= 1
    ctx = TM.UnlearnContext(
        classifier=Classifier(dev), model=model, retain_train=retain,
        forget_train=forget, num_classes=10, batch_size=CLS_BATCH,
        seed=SEED, transform=aug, save_path=save_path, overrides=overrides)
    masks = []
    ratio_mask = TM.fisher_ratio_mask

    def keep_mask(*a, **k):
        masks.append(ratio_mask(*a, **k))
        return masks[-1]

    clock = (cls_clock(TM, CLS_WARMUP - CLS_PROFILED, CLS_PROFILED)
             if chunk == 1 else
             scan_clock(TM, _read_all_launches, n_iters // chunk))
    TM.fisher_ratio_mask = keep_mask
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with stage_clock([(TM, "accumulate_fisher", "fisher")]) as seconds, \
                clock as rec:
            t0 = time.perf_counter()
            unlearned = TM.unlearn_method_registry.get("SFRon")(ctx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        TM.fisher_ratio_mask = ratio_mask
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_fisher = sum(-(-len(d) // CLS_BATCH) for d in (forget, retain))
    density = (sum(int(m.sum()) for m in masks[0].values())
               / sum(m.numel() for m in masks[0].values())) if mask else None
    fisher_s = seconds.get("fisher")
    losses = np.asarray(rec["loss"])
    if len(losses) != n_iters or not np.isfinite(losses).all():
        fail(f"SFRon: {len(losses)} iterations or a loss not finite")
    dp, ds = _moved(unlearned, before)
    if not dp > 0 or not ds > 0:
        fail(f"SFRon: parameters ({dp}) or running statistics ({ds}) did "
             f"not move")
    acc, test_acc = (Classifier(dev).validate(
        unlearned, epoch_batches(d, CLS_BATCH))["acc"] for d in (forget, test))
    name = str(dtype).removeprefix("torch.")
    out = {"n_iters": n_iters, "scan_chunk": chunk,
           "fisher_batches": n_fisher, "fisher_s": fisher_s,
           "mask_density": density, "peak_gib": peak_gib,
           "forget_acc": acc, "test_acc": test_acc, "call_s": wall,
           "losses_first_last": [losses[0].tolist(), losses[-1].tolist()]}
    if not mask:
        fisher = "no mask"
    elif fisher_s is None:
        fisher = (f"the Fishers read from the last run's files; mask "
                  f"density {density:.4f}")
    else:
        out["fisher_batches_per_s"] = n_fisher / fisher_s
        fisher = (f"Fisher pass {n_fisher} batches (eval mode, batch "
                  f"{CLS_BATCH}) in {fisher_s:.3f} s, "
                  f"{n_fisher / fisher_s:.2f} batches/s on the host clock; "
                  f"mask density {density:.4f}")
    head = (f"  SFRon {name}, {n_iters} iterations (cut from 1,500), "
            f"scan_chunk {chunk}: {fisher}")
    tail = (f"peak {peak_gib:.3f} GiB; forget accuracy {acc:.2f}%, test "
            f"{test_acc:.2f}% (random init); the call {wall:.3f} s; on "
            f"{card}")
    if chunk > 1:
        print(f"{head}; {tail}", flush=True)
        out["scan"] = scan_summary(f"SFRon {name}", rec, chunk, card)
        return out
    t = np.asarray(rec["t"][-CLS_TIMED - 1:])
    if len(t) != CLS_TIMED + 1:
        fail(f"SFRon: {len(rec['t'])} timed iterations")
    dt = np.diff(t)
    mean_s = (t[-1] - t[0]) / CLS_TIMED
    busy = rec["busy_ms"] / CLS_PROFILED
    print(f"{head}; iterations median {np.median(dt) * 1e3:.3f} ms "
          f"({1 / np.median(dt):.2f} it/s), mean {mean_s * 1e3:.3f} ms "
          f"({1 / mean_s:.2f} it/s) over {CLS_TIMED} after {CLS_WARMUP} "
          f"warm-up; device busy {busy:.3f} ms an iteration (profiler, "
          f"{CLS_PROFILED} iterations, one a forget step), "
          f"{busy / 1e3 / mean_s:.1%} of the mean; {tail}", flush=True)
    out.update({"iter_ms": (dt * 1e3).tolist(),
                "median_iter_ms": float(np.median(dt) * 1e3),
                "median_iters_per_s": float(1 / np.median(dt)),
                "mean_iter_ms": float(mean_s * 1e3),
                "mean_iters_per_s": float(1 / mean_s),
                "busy_ms_per_iter": busy, "busy_share": busy / 1e3 / mean_s})
    return out


def cls_methods(data, dev, card: str) -> dict:
    """Phase 15: the other eight methods through the registry at one epoch
    each, bf16, on every CLS_METHODS_EVERY-th image of the stand-in's
    retain and forget splits."""
    import numpy as np
    import torch

    from uurg_torch.unlearn.methods import classification as TM
    from uurg_torch.workloads.classification import Classifier

    retain, forget, _, aug = data
    retain, forget = (d.subset(np.arange(0, len(d), CLS_METHODS_EVERY))
                      for d in (retain, forget))
    model = _cls_model(torch.bfloat16, dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    for name in ("Baseline", "Finetune", "Retrain", "GradAscent",
                 "RandomLabel", "SalUn", "BadTeacher", "SCRUB"):
        ctx = TM.UnlearnContext(
            classifier=Classifier(dev), model=model, retain_train=retain,
            forget_train=forget, num_classes=10, batch_size=CLS_BATCH,
            seed=SEED, transform=aug,
            init_fn=lambda s: _cls_model(torch.bfloat16, dev, s),
            overrides=dict(CLS_ONE_EPOCH))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        unlearned = TM.unlearn_method_registry.get(name)(ctx)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        sd = unlearned.state_dict()
        if not all(torch.isfinite(v.float()).all() for v in sd.values()):
            fail(f"{name}: a weight is not finite")
        dp, ds = _moved(unlearned, before)
        trains = name not in ("Baseline", "GradAscent")  # GA: eval mode
        if (dp > 0) != (name != "Baseline") or (ds > 0) != trains:
            fail(f"{name}: parameters moved {dp}, running statistics {ds}")
        if any(not torch.equal(v, model.state_dict()[k])
               for k, v in before.items()):
            fail(f"{name} changed the context's model")
        out[name] = {"seconds": secs, "param_change": dp, "stat_change": ds}
        print(f"  {name} (bf16, one epoch of {len(retain)} retain and "
              f"{len(forget)} forget images): {secs:.3f} s; max |change| "
              f"parameters {dp:.3e}, running statistics {ds:.3e}",
              flush=True)
    print(f"  eight methods on {card}", flush=True)
    return out


@contextlib.contextmanager
def sfron_cut(n_iters: int):
    """The registry's SFRon given the method's ``n_iters`` override while
    the block runs (``main_random``, like the JAX package's CLI, has no
    flag for it)."""
    import dataclasses

    from uurg_torch.unlearn.methods.classification import \
        unlearn_method_registry as reg

    sfron = reg.get("SFRon")
    reg.register("SFRon", lambda ctx: sfron(dataclasses.replace(
        ctx, overrides={**ctx.overrides, "n_iters": n_iters})))
    try:
        yield
    finally:
        reg.register("SFRon", sfron)


def run_cli(name: str, args: list[str]) -> tuple[float, str, str]:
    """``uurg_torch.cli.<name>``'s ``main(args)`` in this process, as
    ``python -m`` calls it (a fault fails the run): (seconds, its standard
    output, its log records at INFO and above)."""
    import importlib
    import io
    import logging

    import torch

    main = importlib.import_module(f"uurg_torch.cli.{name}").main
    out, log = io.StringIO(), io.StringIO()
    handler = logging.StreamHandler(log)
    handler.setFormatter(logging.Formatter(
        "%(levelname)s:%(name)s:%(message)s"))
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            main(args)
        torch.cuda.synchronize()
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    secs = time.perf_counter() - t0
    torch.cuda.empty_cache()
    lines = out.getvalue().strip().splitlines()
    print(f"  {name}: done in {secs:.3f} s [at {time.time() - STARTED:.1f} "
          f"s]; {lines[-1][:300] if lines else ''}", flush=True)
    return secs, out.getvalue(), log.getvalue()


def cls_cli(card: str) -> dict:
    """Phase 15: ``main_random --unlearn_method SFRon --svc_mia --dtype
    bf16`` on the CLI's own stand-in fallback, cut to CLS_CLI_ITERS
    iterations, in this process."""
    import csv
    import shutil

    import numpy as np

    work = tempfile.mkdtemp(prefix="uurg_cls_cli_")
    out = os.path.join(work, "out")
    try:
        with sfron_cut(CLS_CLI_ITERS):
            secs, _, log = run_cli("main_random", [
                "--unlearn_method", "SFRon", "--svc_mia", "--dtype", "bf16",
                "--data_path", os.path.join(work, "no_data"),
                "--save_path", out])
        with open(os.path.join(out, "results.csv")) as f:
            rows = list(csv.DictReader(f))
        want = ["method", "unlearn_time", "retain_acc", "forget_acc",
                "test_acc", "mia", "svc_confidence", "svc_entropy",
                "svc_m_entropy"]
        if len(rows) != 1 or list(rows[0]) != want:
            fail(f"main_random wrote {rows}")
        row = {k: (v if k == "method" else float(v))
               for k, v in rows[0].items()}
        if not all(np.isfinite(v) for k, v in row.items() if k != "method"):
            fail(f"main_random: a value is not finite: {row}")
        rates = re.findall(rf"sfron iter (\d+)/{CLS_CLI_ITERS} .*?"
                           r"\(([\d.]+) it/s\)", log)
        if len(rates) != CLS_CLI_ITERS // 250:
            fail(f"main_random did not run {CLS_CLI_ITERS} iterations: "
                 f"{rates}")
        print(f"  main_random SFRon --svc_mia --dtype bf16 (2,048 / 512 "
              f"stand-in images, {CLS_CLI_ITERS} iterations): "
              f"{secs:.3f} s; row {json.dumps(row)}; logged rates {rates}; "
              f"on {card}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"seconds": secs, "row": row, "logged_rates": rates}


def svc_fit_seconds(card: str) -> float:
    """Phase 15: the SVC attack's fit at SVC_N members and SVC_N
    non-members of 1-D features (the protocol caps each at 4,000), on the
    card's host."""
    import numpy as np

    from uurg_torch.eval.mia import fit_svc

    rng = np.random.default_rng(SEED)
    x = np.concatenate([rng.normal(0.0, 1.0, SVC_N), rng.normal(
        0.8, 1.2, SVC_N)]).astype(np.float32).reshape(-1, 1)
    y = np.concatenate([np.ones(SVC_N), np.zeros(SVC_N)])
    t0 = time.perf_counter()
    predict = fit_svc(x, y)
    secs = time.perf_counter() - t0
    share = float(predict(x).mean())
    print(f"  SVC fit, {SVC_N} + {SVC_N} 1-D features (SMO, numpy): "
          f"{secs:.3f} s "
          f"on the host of {card}; members predicted {share:.3f}",
          flush=True)
    return secs


def classification_path(card: str) -> dict:
    """Phase 15: classification unlearning on ResNet-18, with zero launches
    of the kernels (the four and the float32 attention routes)."""
    import shutil

    import torch

    from uurg_torch.core.device import resolve_device
    from uurg_torch.data.arrays import pad_crop_batch, random_flip_batch
    from uurg_torch.data.datasets import synthetic_dataset
    from uurg_torch.data.splits import random_forget_split

    dev = resolve_device("cuda")           # TF32 off, as every entry point
    _zero_launches()
    errs = cls_card_vs_cpu(dev)
    t0 = time.perf_counter()
    train = synthetic_dataset(CLS_TRAIN, 32, 3, 10, seed=0, base_seed=0,
                              noise_sigma=0.5)
    test = synthetic_dataset(CLS_TEST, 32, 3, 10, seed=1, base_seed=0,
                             noise_sigma=0.5)
    retain, forget = random_forget_split(train, 0.1, SEED)
    print(f"  stand-in {CLS_TRAIN} + {CLS_TEST} images made in "
          f"{time.perf_counter() - t0:.1f} s; {len(forget)} forget, "
          f"{len(retain)} retain", flush=True)

    def aug(x, rng):
        return random_flip_batch(pad_crop_batch(x, 4, rng), rng)

    data = (retain, forget, test, aug)
    fishers = tempfile.mkdtemp(prefix="uurg_cls_fisher_")
    try:
        sfron = {
            "float32": cls_sfron(torch.float32, data, dev, card,
                                 CLS_F32_ITERS, CLS_F32_CHUNK, mask=False),
            "bfloat16": cls_sfron(torch.bfloat16, data, dev, card,
                                  CLS_SCAN_ITERS, save_path=fishers),
            "bfloat16_per_step": cls_sfron(torch.bfloat16, data, dev, card,
                                           CLS_WARMUP + CLS_TIMED, 1,
                                           save_path=fishers)}
    finally:
        shutil.rmtree(fishers, ignore_errors=True)
    methods = cls_methods(data, dev, card)
    torch.cuda.empty_cache()
    cli = cls_cli(card)
    svc_s = svc_fit_seconds(card)
    launches = _read_all_launches()
    print(f"  launches of the kernels on the classification path: "
          f"{launches}", flush=True)
    if any(launches.values()):
        fail("a DDPM kernel launched on the classification path")
    return {"card_vs_cpu_max_abs": errs, "sfron": sfron, "methods": methods,
            "cli": cli, "svc_fit_s": svc_s, "launches": launches}


def _vit_model(name: str, dtype, seed: int = SEED):
    """``create_model(name)`` with flax's init from ``seed`` at 224 px (a
    ViT's 197 tokens), on the CPU."""
    import torch

    from uurg_torch.models import create_model, init_classifier

    return init_classifier(torch.Generator().manual_seed(seed),
                           create_model(name, 10, dtype=dtype),
                           resolution=VIT_RES)


def vit_card_vs_cpu(name: str, dev) -> dict:
    """Phase 17: logits and all parameter gradients of one fp32 forward and
    backward at batch 2, 224 px, on the card against the CPU from the same
    weights; each side's distance from float64 on the CPU. Returns the
    errors and the attention launch counts of the card's call."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.random((VIT_CHECK_BATCH, 3, VIT_RES, VIT_RES),
                                    dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((VIT_CHECK_BATCH, 10)))
    import copy

    base = _vit_model(name, torch.float32)
    f64 = _vit_model(name, torch.float64)
    f64.load_state_dict(base.state_dict())
    out = {}
    for tag, model, where in (("cpu", base, "cpu"), ("card", base, dev),
                              ("float64", f64.double(), "cpu")):
        m = (model if where == "cpu" else
             copy.deepcopy(model).to(where)).train()
        xx = x.to(where, torch.float64 if tag == "float64" else torch.float32)
        _zero_launches()
        logits = m(xx)
        (logits * w.to(where, logits.dtype)).sum().backward()
        if where != "cpu":
            torch.cuda.synchronize()
        out[tag] = {"logits": logits.detach(), "launches":
                    _read_all_launches(), "gradients": torch.cat(
                        [p.grad.reshape(-1) for p in m.parameters()])}
    errs = {"logits": rel_l2(f"{name} logits (fp32, card vs CPU, batch "
                             f"{VIT_CHECK_BATCH}, {VIT_RES} px)",
                             out["card"]["logits"], out["cpu"]["logits"],
                             VIT_REL, "the CPU"),
            "gradients": rel_l2(f"{name} all parameter gradients (fp32, "
                                f"card vs CPU)", out["card"]["gradients"],
                                out["cpu"]["gradients"], VIT_GRAD_REL,
                                "the CPU")}
    ref = out["float64"]["gradients"].cpu()
    for where in ("cpu", "card"):
        g = out[where]["gradients"].detach().cpu().double()
        gap = ((g - ref).norm() / ref.norm()).item()
        lg = out[where]["logits"].cpu().double()
        lref = out["float64"]["logits"].cpu()
        lgap = ((lg - lref).norm() / lref.norm()).item()
        errs[f"fp32 on {where} vs float64"] = {"logits": lgap,
                                               "gradients": gap}
        print(f"  {name} fp32 on {where} against float64 on the CPU: logits "
              f"rel L2 {lgap:.3e}, gradients {gap:.3e}", flush=True)
    return {"errors": errs, "card_launches": out["card"]["launches"]}


def vit_stand_in():
    """A 224 px stand-in (VIT_TRAIN train images of 10 classes, noise 0.5,
    random 10% forgetting) and the flip and pad-crop augmentation."""
    from uurg_torch.data.arrays import pad_crop_batch, random_flip_batch
    from uurg_torch.data.datasets import synthetic_dataset
    from uurg_torch.data.splits import random_forget_split

    train = synthetic_dataset(VIT_TRAIN, VIT_RES, 3, 10, seed=0, base_seed=0,
                              noise_sigma=0.5)
    retain, forget = random_forget_split(train, 0.1, SEED)

    def aug(x, rng):
        return random_flip_batch(pad_crop_batch(x, 4, rng), rng)

    return retain, forget, aug


def vit_sfron(name: str, dtype, data, dev, card: str, n_iters: int,
              mask: bool = True, scan_chunk: int | None = None) -> dict:
    """Phase 17: ``SFRon`` through the registry on the 224 px stand-in at
    batch 64: the Fisher pass and mask (unless ``mask`` is off), then
    ``n_iters`` iterations. Chunked (``scan_chunk`` None: VIT_SCAN_CHUNK)
    under :func:`scan_clock`; step by step (``scan_chunk`` 1) with the
    first VIT_WARMUP - 1 untimed, one profiled, the rest timed. The launch
    counters are zeroed just before and read just after; the model's
    forwards are counted by a hook, those with grad on (each followed by
    one backward) apart. A replay runs no Python: the chunked path's
    counts are the effective ones (:func:`effective`), and its loop's
    forwards must be one an iteration and one a forget step."""
    import numpy as np
    import torch

    from uurg_torch.unlearn.methods import classification as TM
    from uurg_torch.workloads.classification import Classifier

    retain, forget, aug = data
    model = _vit_model(name, dtype).to(dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    calls = []
    hook = model.register_forward_hook(
        lambda mod, args, out: calls.append(torch.is_grad_enabled()))
    chunk = VIT_SCAN_CHUNK if scan_chunk is None else scan_chunk
    ctx = TM.UnlearnContext(
        classifier=Classifier(dev), model=model, retain_train=retain,
        forget_train=forget, num_classes=10, batch_size=VIT_BATCH,
        seed=SEED, transform=aug,
        overrides={"n_iters": n_iters, "mask": mask, "scan_chunk": chunk})

    def counters():
        return {**_read_all_launches(), "forwards": len(calls),
                "grad_forwards": sum(calls)}

    profiled = min(1, n_iters - 1)
    clock = (cls_clock(TM, VIT_WARMUP - 1, profiled) if chunk == 1 else
             scan_clock(TM, counters, n_iters // chunk))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with clock as rec:
        _zero_launches()
        t0 = time.perf_counter()
        unlearned = TM.unlearn_method_registry.get("SFRon")(ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        raw = counters()
    hook.remove()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = np.asarray(rec["loss"])
    if len(losses) != n_iters or not np.isfinite(losses).all():
        fail(f"{name} SFRon: {len(losses)} iterations or a loss not finite")
    moved = max(float((unlearned.state_dict()[k].float() - v.float()).abs()
                      .max()) for k, v in before.items())
    if not moved > 0:
        fail(f"{name} SFRon: the parameters did not move")
    if any(not torch.equal(v, model.state_dict()[k])
           for k, v in before.items()):
        fail(f"{name} SFRon changed the context's model")
    tag = f"{name} {str(dtype).removeprefix('torch.')}"
    counts = raw if chunk == 1 else effective(raw, rec)
    launches = {k: v for k, v in counts.items() if "forwards" not in k}
    out = {"launches": launches, "forwards": counts["forwards"],
           "grad_forwards": counts["grad_forwards"], "call_s": wall,
           "scan_chunk": chunk, "n_iters": n_iters, "peak_gib": peak_gib,
           "losses_first_last": [losses[0].tolist(), losses[-1].tolist()]}
    head = (f"  {tag} SFRon ({n_iters} iterations, scan_chunk {chunk}, "
            f"batch {VIT_BATCH}, {VIT_RES} px"
            f"{', Fisher mask' if mask else ', no mask'}): "
            f"{counts['forwards']} forwards ({counts['grad_forwards']} with "
            f"a backward), the call {wall:.3f} s; peak {peak_gib:.3f} GiB; "
            f"launches {launches}")
    if chunk > 1:
        loop = counts["grad_forwards"] - rec["at_first_chunk"]["grad_forwards"]
        want = n_iters + -(-n_iters // 5)
        print(f"{head} (effective: the counters read {raw}, a replay "
              f"repeats a capture's {list(rec['captured'].values())}); "
              f"the loop's forwards {loop} (expected {want}: one an "
              f"iteration, one a forget step); on {card}", flush=True)
        if loop != want:
            fail(f"{tag} SFRon: {loop} forwards in the chunked loop, not "
                 f"{want}")
        out["raw_counts"] = raw
        out["scan"] = scan_summary(f"{tag} SFRon", rec, chunk, card)
        return out
    # the clock reads after every iteration but the profiled one
    t = np.asarray(rec["t"][VIT_WARMUP - 1:] if n_iters > VIT_WARMUP
                   else rec["t"])
    dt = np.diff(t)
    print(f"{head}; iterations median "
          f"{np.median(dt) * 1e3 if len(dt) else float('nan'):.3f} ms, mean "
          f"{dt.mean() * 1e3 if len(dt) else float('nan'):.3f} over "
          f"{len(dt)}; device busy {rec['busy_ms'] / max(profiled, 1):.3f} "
          f"ms in the profiled iteration; on {card}", flush=True)
    out.update({"iter_ms": (dt * 1e3).tolist(),
                "median_iter_ms": (float(np.median(dt) * 1e3) if len(dt)
                                   else None),
                "mean_iter_ms": float(dt.mean() * 1e3) if len(dt) else None,
                "busy_ms_profiled_iter": rec["busy_ms"] / max(profiled, 1)})
    return out


def _expect_launches(tag: str, got: dict, want: dict) -> None:
    print(f"  {tag} launches: {got} (expected {want})", flush=True)
    if got != want:
        fail(f"{tag}: the attention launches are not exactly one a block "
             f"a forward and a backward on the expected route")


def vit_clis(card: str) -> dict:
    """Phase 17: ``main_random --unlearn SFRon --model ViT_B`` on its
    stand-in fallback (fp32, 32 px: 5 tokens; SFRon cut to VIT_CLI_ITERS
    iterations), then the north-star
    helpers: ``save_base_dataset --as_npz``, ``train_classifier`` for one
    epoch (32 steps at batch 64, 224 px) and ``classifier_evaluation``
    reading its ``.pth`` on the npz; each in this process."""
    import csv
    import shutil

    import numpy as np

    work = tempfile.mkdtemp(prefix="uurg_vit_cli_")
    none = os.path.join(work, "no_data")
    probe = os.path.join(work, "probe")
    runs = [
        ("main_random", ["--unlearn", "SFRon", "--model", "ViT_B",
                         "--data_path", none,
                         "--save_path", os.path.join(work, "cls")]),
        ("save_base_dataset", ["--data_path", none, "--as_npz", "--out",
                               os.path.join(work, "ref")]),
        ("train_classifier", ["--data_path", none, "--epochs", "1",
                              "--save_path", probe]),
        ("classifier_evaluation", [
            os.path.join(work, "ref.npz"), "--classifier_ckpt",
            os.path.join(probe, "cifar10_resnet34.pth"), "--csv",
            os.path.join(work, "ua.csv")]),
    ]
    out = {}
    try:
        for name, args in runs:
            with sfron_cut(VIT_CLI_ITERS):
                secs, _, _ = run_cli(name, args)
            out[name] = {"seconds": secs}
        with open(os.path.join(work, "cls", "results.csv")) as f:
            rows = list(csv.DictReader(f))
        if len(rows) != 1 or rows[0]["method"] != "SFRon" or not all(
                np.isfinite(float(v)) for k, v in rows[0].items()
                if k != "method"):
            fail(f"main_random --model ViT_B wrote {rows}")
        ref = np.load(os.path.join(work, "ref.npz"))["arr_0"]
        if ref.dtype != np.uint8 or ref.shape[1:] != (32, 32, 3):
            fail(f"save_base_dataset wrote {ref.dtype} {ref.shape}")
        with open(os.path.join(work, "ua.csv")) as f:
            ua = list(csv.DictReader(f))
        if len(ua) != 1 or not 0.0 <= float(ua[0]["forget_accuracy"]) <= 1:
            fail(f"classifier_evaluation wrote {ua}")
        out["main_random_row"] = rows[0]
        out["ua_row"] = ua[0]
        print(f"  main_random ViT_B row {json.dumps(rows[0])}; "
              f"{len(ref)} references; UA row {json.dumps(ua[0])}; on "
              f"{card}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def vit_path(card: str) -> dict:
    """Phase 17: ViT-B/16 and Swin-T classification on the card."""
    import torch

    from uurg_torch.core.device import resolve_device

    dev = resolve_device("cuda")           # TF32 off, as every entry point
    out = {}
    check = vit_card_vs_cpu("ViT_B", dev)
    _expect_launches("ViT_B fp32 card check (1 forward, 1 backward)",
                     check["card_launches"],
                     {**{k: 0 for k in check["card_launches"]},
                      "attention_fwd_f32": VIT_BLOCKS,
                      "attention_bwd_f32": VIT_BLOCKS})
    out["vit_check"] = check
    t0 = time.perf_counter()
    data = vit_stand_in()
    print(f"  stand-in {VIT_TRAIN} images at {VIT_RES} px made in "
          f"{time.perf_counter() - t0:.1f} s; {len(data[1])} forget, "
          f"{len(data[0])} retain", flush=True)
    for dtype, route in ((torch.float32, "_f32"), (torch.bfloat16, "")):
        for n_iters, chunk, kind in (
                (VIT_SCAN_ITERS, None, ""),
                (VIT_WARMUP + VIT_TIMED, 1, "_per_step")):
            run = vit_sfron("ViT_B", dtype, data, dev, card, n_iters,
                            scan_chunk=chunk)
            want = {k: 0 for k in run["launches"]}
            want[f"attention_fwd{route}"] = VIT_BLOCKS * run["forwards"]
            want[f"attention_bwd{route}"] = VIT_BLOCKS * run["grad_forwards"]
            _expect_launches(f"ViT_B {str(dtype).removeprefix('torch.')} "
                             f"SFRon{kind.replace('_', ' ')}",
                             run["launches"], want)
            out[f"vit_sfron{route or '_bf16'}{kind}"] = run
            torch.cuda.empty_cache()
    swin = vit_card_vs_cpu("Swin_T", dev)
    run = vit_sfron("Swin_T", torch.float32, data, dev, card, SWIN_ITERS,
                    mask=False, scan_chunk=1)
    for tag, launches in (("Swin_T card check", swin["card_launches"]),
                          ("Swin_T SFRon", run["launches"])):
        _expect_launches(tag, launches, {k: 0 for k in launches})
    out["swin_check"], out["swin_sfron"] = swin, run
    torch.cuda.empty_cache()
    out["clis"] = vit_clis(card)
    return out


def remat_path(config, card: str, n_attn: int, n_gn: int) -> dict:
    """After phase 17: the full-width CondUNet with ``model.remat`` against
    the same weights without, one train-mode loss and backward at batch 128
    each (dropout drawn from the same seeded generator): the loss equal, the
    gradients within REMAT_SPREAD times the plain step's own spread (the
    plain step run twice; bit-equal where that is 0), 44 more GroupNorm forward launches (two a residual block) and
    the peak memory of each. Then ``sfron_forget`` for REMAT_STEPS steps
    with remat and an Adam second moment in bf16, against the same steps
    without remat: exact launch counts, finite losses, step times, peak
    memory."""
    import numpy as np
    import torch

    from uurg_torch.models.layers import ResnetBlockDDPM
    from uurg_torch.workloads import ddpm_runner as R
    from uurg_torch.workloads.ddpm import DDPMWorkload

    class Args:
        seed = SEED
        ckpt_folder = None
        label_to_forget = 0
        forget_alpha = FORGET_ALPHA
        method = "ron"
        unlearn_loss = "adaga"
        nu_dtype = torch.bfloat16

    configs = {"plain": config,
               "remat": config.merged({"model": {"remat": True}})}
    rng = np.random.default_rng(SEED)
    batch = (torch.from_numpy(rng.random((TRAIN_BATCH, 32, 32, 3),
                                         dtype=np.float32) * 2 - 1).cuda(),
             torch.from_numpy(rng.integers(0, 10, TRAIN_BATCH)).cuda())
    res = {}
    for tag in ("plain", "plain", "remat"):
        wl = DDPMWorkload.from_config(configs[tag])
        model = R.load_params(Args, configs[tag], wl).train()
        n_blocks = sum(isinstance(m, ResnetBlockDDPM)
                       for m in model.modules())
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        loss = wl.train_loss_fn()(model, batch, gen)
        fwd = _read_launches()["group_norm_fwd"]
        loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = _read_launches()
        grads = torch.cat([p.grad.float().reshape(-1)
                           for p in model.parameters()])
        key = tag if tag not in res else "plain again"
        res[key] = {"loss": loss.detach(), "grads": grads, "peak_gib": peak,
                    "forward_gn": fwd, "launches": launches,
                    "gen_state": gen.get_state()}
        del model, wl, loss
        torch.cuda.empty_cache()
    plain, again, remat = res["plain"], res["plain again"], res["remat"]
    if not torch.equal(plain["loss"], remat["loss"]):
        fail(f"remat changed the loss: {plain['loss'].item()} vs "
             f"{remat['loss'].item()}")
    if not torch.equal(plain["gen_state"], remat["gen_state"]):
        fail("remat left the dropout generator elsewhere")
    spread = ((again["grads"] - plain["grads"]).norm()
              / plain["grads"].norm()).item()
    print(f"  plain step twice: gradients rel L2 {spread:.3e} (the run-to-"
          f"run spread)", flush=True)
    grad_err = rel_l2("remat vs plain gradients (bf16, batch "
                      f"{TRAIN_BATCH})", remat["grads"], plain["grads"],
                      REMAT_SPREAD * spread, "the step without remat")
    extra = remat["launches"]["group_norm_fwd"] - \
        plain["launches"]["group_norm_fwd"]
    want_extra = 2 * n_blocks
    print(f"  GroupNorm forward launches: plain {plain['launches']}, remat "
          f"{remat['launches']}: {extra} more in the backward (expected "
          f"{want_extra} = 2 x {n_blocks} residual blocks); forward alone "
          f"{plain['forward_gn']} and {remat['forward_gn']} (sites {n_gn})",
          flush=True)
    if extra != want_extra or want_extra != 44 or not \
            plain["forward_gn"] == remat["forward_gn"] == n_gn:
        fail("remat did not recompute exactly the residual blocks' two "
             "GroupNorms")
    for k in ("attention_fwd", "attention_bwd", "group_norm_bwd"):
        if plain["launches"][k] != remat["launches"][k]:
            fail(f"remat changed the {k} launches")
    print(f"  peak memory of the step: plain {plain['peak_gib']:.3f} GiB, "
          f"remat {remat['peak_gib']:.3f} GiB on {card}", flush=True)

    steps = {}
    for tag in ("plain", "remat"):
        cfg = configs[tag].merged({"training": {
            "n_iters": REMAT_STEPS, "snapshot_freq": 10 ** 6,
            "log_freq": 10 ** 6}})
        ckpt_dir = tempfile.mkdtemp(prefix="uurg_remat_")
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with step_clock(R) as rec:
                _zero_launches()
                t0 = time.time()
                state = R.sfron_forget(Args, cfg, ckpt_dir)
                torch.cuda.synchronize()
                wall = time.time() - t0
                launches = _read_all_launches()
        finally:
            for name in os.listdir(ckpt_dir):
                os.remove(os.path.join(ckpt_dir, name))
            os.rmdir(ckpt_dir)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        nu = [s["nu"].dtype for s in state.optimizer.state.values()]
        if not nu or any(d != torch.bfloat16 for d in nu):
            fail(f"{tag}: the Adam second moments are not bf16: {set(nu)}")
        losses = [(float(m["forget_loss"]), float(m["remain_loss"]))
                  for m in rec["metrics"]]
        if len(losses) != REMAT_STEPS or not np.isfinite(losses).all():
            fail(f"{tag} SFR-on steps: {losses}")
        phases = 2 * REMAT_STEPS
        want = {"attention_fwd": n_attn * phases,
                "attention_bwd": n_attn * phases,
                "group_norm_fwd": (n_gn + (44 if tag == "remat" else 0))
                * phases,
                "group_norm_bwd": n_gn * phases,
                "attention_fwd_f32": 0, "attention_bwd_f32": 0}
        print(f"  {tag} SFR-on, nu bf16, {REMAT_STEPS} steps: launches "
              f"{launches} (expected {want})", flush=True)
        if launches != want:
            fail(f"{tag} SFR-on steps: launch counts")
        step_s = np.diff(rec["t"])
        steps[tag] = {"launches": launches, "losses": losses,
                      "step_ms": (step_s * 1e3).tolist(), "peak_gib": peak,
                      "call_s": wall}
        print(f"  {tag}: steps {np.round(step_s * 1e3, 3).tolist()} ms, "
              f"peak {peak:.3f} GiB, call {wall:.3f} s on {card}",
              flush=True)
        del state
        torch.cuda.empty_cache()
    return {"loss": plain["loss"].item(), "grad_rel_l2": grad_err,
            "plain_spread_rel_l2": spread, "extra_gn_fwd": extra,
            "step_peak_gib": {"plain": plain["peak_gib"],
                              "remat": remat["peak_gib"]},
            "sfron": steps,
            "launches": {k: steps["remat"]["launches"][k]
                         for k in steps["remat"]["launches"]}}


def perturb_dit_(model, seed: int = SEED):
    """Add a seeded normal draw to every parameter (matrices by 0.5 /
    sqrt(fan_in), vectors by 0.05), so every adaLN gate is O(0.1-1): a
    fresh DiT's adaLN-Zero layers make its output 0 and its attention
    invisible to any comparison. Returns ``model``."""
    import torch

    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            std = 0.5 / p[0].numel() ** 0.5 if p.ndim >= 2 else 0.05
            p.add_(torch.randn(p.shape, generator=gen, device=dev) * std)
    return model


def dit_attention_kernels(gen) -> tuple[list[dict], list[dict]]:
    """Phase 18: the attention kernels at DiT-XL/2's shape. bf16 at
    DIT_ATTN_SHAPE, at the true width D = 72: the forward with and without
    its log-sum-exp (training and sampling), the log-sum-exp and the
    backward against the plain versions, three runs with equal bits; the
    same calls on MHSA's layout (q, k, v views of one fused projection, a
    token-major gradient) with the same bits as on contiguous inputs, and
    no pad op in a forward and backward through the dispatcher; then the
    kernels on both layouts, the plain version and bf16 SDPA with its
    backward timed by CUDA-graph replay. float32 at DIT_F32_SHAPE (the wide
    route, D = 72 -> 128) the same way against float32 SDPA (TF32 off).
    Bounds count the true D = 72. Returns (bf16 rows, float32 rows), per
    launch."""
    import torch
    import torch.nn.functional as F

    from uurg_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for shape, dtype in ((DIT_ATTN_SHAPE, torch.bfloat16),
                         (DIT_F32_SHAPE, torch.float32)):
        B, H, T, D = shape
        f32 = dtype == torch.float32
        views = mhsa_views(B, H, T, D, gen, dtype)
        q, k, v, g = (t.contiguous() for t in views)
        route = FA._f32_plan(B, H, T, D).route if f32 else "bf16"
        tag = f"{route} B={B} H={H} T={T} D={D}"

        def run(q=q, k=k, v=v, g=g):
            o, lse = FA._attention_kernel(q, k, v, with_lse=True)
            with torch.no_grad():
                sample = FA.attention(q, k, v)
            return (o, lse, sample, *FA.attention_bwd(q, k, v, o, lse, g))

        first = run()
        torch.cuda.synchronize()
        o, lse, sample = first[:3]
        plain = FA.attention_plain(q, k, v)
        want = FA.attention_bwd_plain(q, k, v, g)
        if f32:
            fwd_err = max(rel_l2(f"attention {tag}", o, plain, F32_FWD_REL),
                          rel_l2(f"attention, no lse, {tag}", sample, plain,
                                 F32_FWD_REL))
            bwd_err = max(rel_l2(f"attention bwd d{n} {tag}", a, b,
                                 F32_BWD_REL)
                          for n, a, b in zip("qkv", first[3:], want))
        else:
            fwd_err = max(compare(f"attention {tag}", o, plain),
                          compare(f"attention, no lse, {tag}", sample,
                                  plain))
            bwd_err = max(rel_l2(f"attention bwd d{n} {tag}", a, b,
                                 BWD_REL_L2)
                          for n, a, b in zip("qkv", first[3:], want))
        check_lse(f"attention {tag}", lse, q, k)
        for _ in range(RAGGED_REPEATS - 1):
            if not all(torch.equal(a, b) for a, b in zip(run(), first)):
                fail(f"attention {tag}: repeated runs differ in their bits")
        if not all(torch.equal(a, b) for a, b in zip(run(*views), first)):
            fail(f"attention {tag}: MHSA's views and contiguous inputs "
                 f"differ in their bits")

        def fwd_bwd():
            leaves = [t.detach().requires_grad_() for t in views[:3]]
            FA.attention(*leaves).backward(views[3])

        backends = sdpa_backend_names(q, k, v, g)
        pads = pad_ops(fwd_bwd)
        print(f"  {tag}: {RAGGED_REPEATS} runs with equal bits, MHSA's "
              f"views the same bits; pad ops in a forward and backward on "
              f"the views: {pads}; SDPA kernels: {backends}", flush=True)
        if not f32 and pads:
            fail(f"attention {tag}: the bf16 route pads")
        lib, stream = library_bwd(F.scaled_dot_product_attention, (q, k, v),
                                  g)
        times = {
            "fwd": (time_ms(lambda: FA._attention_kernel(q, k, v,
                                                         with_lse=True)),
                    time_ms(lambda: FA.attention_plain(q, k, v))[0],
                    time_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v))[0]),
            "bwd": (time_ms(lambda: FA.attention_bwd(q, k, v, o, lse, g)),
                    time_ms(lambda: FA.attention_bwd_plain(q, k, v, g))[0],
                    time_ms(lib, stream=stream)[0])}
        nolse_ms = time_ms(lambda: FA._attention_kernel(q, k, v,
                                                        with_lse=False))[0]
        # the dispatcher and SDPA on MHSA's layout, as DiT calls them
        qv, kv, vv, gv = views
        ov, lsev = FA._attention_kernel(qv, kv, vv, with_lse=True)
        lib_v, stream_v = library_bwd(F.scaled_dot_product_attention,
                                      (qv, kv, vv), gv)
        on_views = {
            "fwd": (time_ms(lambda: FA._attention_kernel(qv, kv, vv,
                                                         with_lse=True)),
                    time_ms(lambda: F.scaled_dot_product_attention(
                        qv, kv, vv))[0]),
            "bwd": (time_ms(lambda: FA.attention_bwd(qv, kv, vv, ov, lsev,
                                                     gv)),
                    time_ms(lib_v, stream=stream_v)[0])}
        n = B * H * T * D
        peak = FP32_FLOPS if f32 else BF16_TC_FLOPS
        suffix = "_f32" if f32 else ""
        for kind, nbytes, ops, err in (("fwd", 4 * n, 4 * n * T, fwd_err),
                                       ("bwd", 7 * n, 10 * n * T, bwd_err)):
            (ms, eager), plain_ms, lib_ms = times[kind]
            bytes_ms = nbytes * q.element_size() / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / peak * 1e3
            (views_ms, views_eager), lib_views_ms = on_views[kind]
            row = {"name": f"attention_{kind}{suffix}",
                   "shape": {"B": B, "H": H, "T": T, "D": D},
                   "route": route, "ms": ms, "eager_ms": eager,
                   "views_ms": views_ms, "views_eager_ms": views_eager,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library_views_ms": lib_views_ms,
                   "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": ("bytes" if bytes_ms >= ops_ms
                                else "operations"),
                   "max_abs_err": err, "pad_ops": pads}
            if kind == "fwd":
                row.update(no_lse_ms=nolse_ms)
            out.append(row)
            print(f"  attention_{kind}{suffix} {row['shape']}: kernel "
                  f"{ms:.4f} ms (eager {eager:.4f} ms"
                  + (f"; no lse {nolse_ms:.4f} ms" if kind == "fwd" else "")
                  + f"), on MHSA's views {views_ms:.4f} ms (eager "
                  f"{views_eager:.4f} ms), plain {plain_ms:.4f} ms, SDPA "
                  f"{lib_ms:.4f} ms (on the views {lib_views_ms:.4f} ms), "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
                  f"D = {D})", flush=True)
    return ([r for r in out if not r["name"].endswith("_f32")],
            [r for r in out if r["name"].endswith("_f32")])


def dit_bf16_check(gen) -> dict:
    """Phase 18: the full-width DiT-XL/2 in bf16 (seeded init, perturbed)
    at batch DIT_CHECK_BATCH on the card, kernels against the same model on
    its plain path: a forward (MODEL_REL_L2) that a zeroed attention must
    move by more than that gate, and the gradients of the hybrid loss at
    fixed t and noise through full remat (MODEL_GRAD_REL_L2); exact launch
    counts, GroupNorm's 0."""
    import torch

    from uurg_torch.models import dit as TDm
    from uurg_torch.workloads.dit import DiTWorkload

    wl = DiTWorkload.build(DIT_NAME)            # CUDA, bf16, full remat
    model = perturb_dit_(wl.init_params(SEED))
    n, dev = DIT_CHECK_BATCH, wl.device
    x = torch.randn(n, 32, 32, 4, generator=gen, device=dev)
    noise = torch.randn(n, 32, 32, 4, generator=gen, device=dev)
    t = torch.randint(0, 1000, (n,), generator=gen, device=dev)
    y = torch.randint(0, 1000, (n,), generator=gen, device=dev)
    keep = torch.arange(n, device=dev) % 2 == 0
    _zero_launches()
    with torch.inference_mode():
        got = model(x, t, y, keep)
        fwd_launches = _read_all_launches()
        with plain_layers():
            want = model(x, t, y, keep)
        kernel = TDm.attention
        TDm.attention = lambda q, k, v: torch.zeros_like(q)
        try:
            blind = model(x, t, y, keep)
        finally:
            TDm.attention = kernel
    if not torch.isfinite(got).all():
        fail("DiT forward with kernels is not finite")
    rel = ((got - want).norm() / want.norm()).item()
    seen = ((blind - got).norm() / got.norm()).item()
    print(f"  batch-{n} bf16 forward, kernels vs plain path: rel L2 "
          f"{rel:.3e} (tolerance {MODEL_REL_L2:g}); a zeroed attention "
          f"moves it by {seen:.3e}", flush=True)
    if rel > MODEL_REL_L2:
        fail("the DiT with kernels disagrees with its plain path")
    if not seen > MODEL_REL_L2:
        fail("the DiT's output does not see its attention")
    params = list(model.parameters())

    def grads():
        loss = wl.per_sample_loss(model, x, y, t, noise).mean()
        return torch.cat([a.float().reshape(-1) for a in torch.autograd.grad(
            loss, params)])

    _zero_launches()
    g_kernel = grads()
    torch.cuda.synchronize()
    grad_launches = _read_all_launches()
    with plain_layers():
        g_plain = grads()
    grad_rel = rel_l2(f"batch-{n} bf16 gradients (hybrid loss, full remat),"
                      f" kernels vs plain path", g_kernel, g_plain,
                      MODEL_GRAD_REL_L2, "the plain path")
    zero = {k: 0 for k in fwd_launches}
    _expect_launches("DiT bf16 forward", fwd_launches,
                     {**zero, "attention_fwd": DIT_BLOCKS})
    _expect_launches("DiT bf16 gradients (full remat)", grad_launches,
                     {**zero, "attention_fwd": 2 * DIT_BLOCKS,
                      "attention_bwd": DIT_BLOCKS})
    return {"forward_rel_l2": rel, "zeroed_attention_rel_l2": seen,
            "gradients_max_abs_err": grad_rel}


def dit_f32_card_vs_cpu(dev) -> dict:
    """Phase 18: DIT_F32_BLOCKS blocks of DiT-XL/2 at full width in fp32
    (TF32 off, seeded init, perturbed), at batch DIT_F32_BATCH: the output
    and all parameter gradients on the card against the CPU from the same
    weights, each side's distance from float64 on the CPU; the card's call
    exactly one float32 attention forward and backward a block."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from uurg_torch.models.dit import DiT, DiT_configs, init_dit

    cfg = dataclasses.replace(DiT_configs[DIT_NAME](), depth=DIT_F32_BLOCKS,
                              dtype=torch.float32, remat=False)
    base = perturb_dit_(init_dit(SEED, cfg, "cpu"))
    f64 = DiT(dataclasses.replace(cfg, dtype=torch.float64,
                                  norm_dtype=torch.float64)).double()
    f64.load_state_dict(base.state_dict())
    rng = np.random.default_rng(SEED)
    n = DIT_F32_BATCH
    x = torch.from_numpy(rng.standard_normal((n, 32, 32, 4)))
    w = torch.from_numpy(rng.standard_normal((n, 32, 32, 8)))
    t, y = torch.tensor([10, 700][:n]), torch.tensor([3, 999][:n])
    keep = torch.tensor([True, False][:n])
    out = {}
    for tag, model, where in (("cpu", base, "cpu"), ("card", base, dev),
                              ("float64", f64, "cpu")):
        m = model if where == "cpu" else copy.deepcopy(model).to(where)
        dt = torch.float64 if tag == "float64" else torch.float32
        _zero_launches()
        o = m(x.to(where, dt), t.to(where), y.to(where), keep.to(where))
        (o * w.to(where, dt)).sum().backward()
        if where != "cpu":
            torch.cuda.synchronize()
        out[tag] = {"out": o.detach().cpu().double(),
                    "launches": _read_all_launches(),
                    "gradients": torch.cat([p.grad.reshape(-1).cpu().double()
                                            for p in m.parameters()])}
        del m
    errs = {"out": rel_l2(f"{DIT_F32_BLOCKS}-block DiT-XL/2 output (fp32, "
                          f"card vs CPU, batch {n})", out["card"]["out"],
                          out["cpu"]["out"], DIT_REL, "the CPU"),
            "gradients": rel_l2("its parameter gradients (fp32, card vs "
                                "CPU)", out["card"]["gradients"],
                                out["cpu"]["gradients"], DIT_GRAD_REL,
                                "the CPU")}
    for where in ("cpu", "card"):
        gaps = {}
        for key in ("out", "gradients"):
            ref = out["float64"][key]
            gaps[key] = ((out[where][key] - ref).norm() / ref.norm()).item()
        errs[f"fp32 on {where} vs float64"] = gaps
        print(f"  fp32 on {where} against float64 on the CPU: output rel L2 "
              f"{gaps['out']:.3e}, gradients {gaps['gradients']:.3e}",
              flush=True)
    launches = out["card"]["launches"]
    _expect_launches("DiT fp32 card check (1 forward, 1 backward)", launches,
                     {**{k: 0 for k in launches},
                      "attention_fwd_f32": DIT_F32_BLOCKS,
                      "attention_bwd_f32": DIT_F32_BLOCKS})
    return {"errors": errs, "card_launches": launches}


def dit_stand_in(work: str) -> str:
    """DIT_LATENTS seeded (32, 32, 4) float32 latents with labels uniform
    over DIT_STANDIN_CLASSES classes, written by the port's
    ``write_latent_shards`` into DIT_SHARDS shards; returns their
    directory."""
    import numpy as np

    from uurg_torch.data.lazy import write_latent_shards

    rng = np.random.default_rng(SEED)
    n = DIT_LATENTS // DIT_SHARDS
    batches = ((rng.standard_normal((n, 32, 32, 4)).astype(np.float32),
                rng.integers(0, DIT_STANDIN_CLASSES, n))
               for _ in range(DIT_SHARDS))
    paths = write_latent_shards(os.path.join(work, "latents", "shard"),
                                batches, n)
    if len(paths) != DIT_SHARDS:
        fail(f"write_latent_shards wrote {len(paths)} shards")
    return os.path.dirname(paths[0])


def dit_checkpoint(work: str) -> str:
    """The seeded DiT-XL/2, perturbed as the checks' models are, written by
    the port's ``save_dit_checkpoint`` as a reference ``.pt``; returns its
    path."""
    from uurg_torch.io.dit_interop import save_dit_checkpoint
    from uurg_torch.models.dit import DiT_configs, init_dit

    model = perturb_dit_(init_dit(SEED, DiT_configs[DIT_NAME](), "cuda"))
    path = os.path.join(work, "dit_xl2_seeded.pt")
    save_dit_checkpoint(path, model)
    return path


def dit_clis(work: str, data: str, ckpt: str) -> tuple[dict, str]:
    """Phase 18: the three DiT CLIs on the stand-in, each in this process
    on the card (DiT-XL/2 from ``ckpt``): ``dit_generate_fisher`` (class 0,
    DIT_FISHER_ITERS batches of 1), ``dit_generate_mask`` (threshold 1.0),
    ``forget`` (the mask packed, adaga, DIT_CLI_ITERS steps, snapshots and
    checkpoints every 3). The Fishers finite, non-negative and not all
    zero; the mask 0/1 and not all one value; the logged losses finite;
    ``final.pt`` and the sample grids written, and ``final.pt`` read back by
    the port's ``load_dit_reference_checkpoint``."""
    import re
    import shutil

    import numpy as np
    import torch

    from uurg_torch.core.tree import sparsity
    from uurg_torch.io.checkpoint import restore_checkpoint
    from uurg_torch.io.dit_interop import load_dit_reference_checkpoint
    from uurg_torch.models.dit import build_dit

    masks = os.path.join(work, "masks")
    fdir = os.path.join(masks, "0")
    res = {}
    res["fisher_s"], _, _ = run_cli("dit_generate_fisher", [
        "--data-path", data, "--ckpt", ckpt, "--forget-class", "0",
        "--n-iters", str(DIT_FISHER_ITERS), "--mask-path", masks])
    for name in ("forget_fisher", "remain_fisher"):
        f = restore_checkpoint(os.path.join(fdir, name))
        total = sum(float(v.double().sum()) for v in f.values())
        if not (all(bool(torch.isfinite(v).all() and (v >= 0).all())
                    for v in f.values()) and total > 0):
            fail(f"{name}: not finite and non-negative, or all zero")
        res[f"{name}_sum"] = total
        del f
    res["mask_s"], _, _ = run_cli("dit_generate_mask", [
        "--mask-path", masks, "--forget-class", "0", "--thresholds", "1.0"])
    for name in ("forget_fisher", "remain_fisher"):     # 2.7 GB each
        os.remove(os.path.join(fdir, name))
    mask_path = os.path.join(fdir, "fisher_1.0")
    mask = restore_checkpoint(mask_path)
    if not all(v.dtype == torch.bool for v in mask.values()):
        fail("the mask file holds leaves that are not 0/1")
    res["mask_sparsity"] = sparsity(mask)
    print(f"  mask fisher_1.0: sparsity {res['mask_sparsity']:.4f}",
          flush=True)
    if not 0.0 < res["mask_sparsity"] < 1.0:
        fail("the mask is all one value")
    del mask
    results = os.path.join(work, "results")
    res["forget_s"], _, log_text = run_cli("forget", [
        "--data-path", data, "--ckpt", ckpt, "--mask-path", mask_path,
        "--pack_mask",
        "--unlearn-loss", "adaga", "--n-iters", str(DIT_CLI_ITERS),
        "--snapshot-every", "3", "--ckpt-every", "3", "--log-every", "1",
        "--results-dir", results])
    losses = [(float(a), float(b)) for a, b in re.findall(
        r"step \d+ forget (\S+) remain (\S+)", log_text)]
    run = os.path.join(results, "forget_0")
    print(f"  forget: logged losses {losses}; wrote "
          f"{sorted(os.listdir(run))}", flush=True)
    if len(losses) != DIT_CLI_ITERS or not np.isfinite(losses).all():
        fail("the forget CLI's logged losses are missing or not finite")
    for name in ("final.pt", "train_state.pt", "ckpt_0000002.pt",
                 "vis_step000002.npz"):
        if not os.path.exists(os.path.join(run, name)):
            fail(f"the forget CLI wrote no {name}")
    with np.load(os.path.join(run, "vis_step000002.npz")) as d:
        lat = d["latents"]
    if lat.shape != (2 * DIT_GRID_CLASSES, 32, 32, 4) or \
            not np.isfinite(lat).all():
        fail(f"vis_step000002.npz holds {lat.shape} latents, or not finite")
    model, _ = build_dit(DIT_NAME, device="cuda")
    load_dit_reference_checkpoint(os.path.join(run, "final.pt"), model)
    if not all(bool(torch.isfinite(p).all()) for p in model.parameters()):
        fail("final.pt holds non-finite weights")
    res["losses"] = losses
    del model
    shutil.rmtree(results)
    torch.cuda.empty_cache()
    return res, mask_path


@contextlib.contextmanager
def dit_clock(runner, profile_step: int | None = None,
              families: bool = False):
    """Wrap the SFR-on step that ``runner.make_sfron_step`` builds: after
    each step, wait for the device and read the clock, and keep the losses;
    the step numbered ``profile_step`` runs under the profiler instead (its
    device busy ms, by kernel family with ``families``, and its wall ms
    kept). The run still goes through the runner's own entry point and
    step."""
    import torch

    record = {"t": [], "loss": [], "busy_ms": None, "profiled_ms": None,
              "by_family": None}
    make = runner.make_sfron_step

    def timed_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(state, *batches):
            out = {}
            if state.step == profile_step:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if families:
                    record["by_family"] = device_ms_by_family(
                        "an SFR-on step",
                        lambda: out.update(step(state, *batches)))
                    record["busy_ms"] = sum(record["by_family"].values())
                else:
                    record["busy_ms"] = device_busy_ms(
                        "a DiT SFR-on step",
                        lambda: out.update(step(state, *batches)))
                record["profiled_ms"] = (time.perf_counter() - t0) * 1e3
            else:
                out = step(state, *batches)
                torch.cuda.synchronize()
                record["t"].append(time.perf_counter())
            record["loss"].append((float(out["forget_loss"]),
                                   float(out["remain_loss"])))
            return out

        return timed

    runner.make_sfron_step = timed_make
    try:
        yield record
    finally:
        runner.make_sfron_step = make


def dit_train(data: str, ckpt: str, mask_path: str, policy, card: str):
    """Phase 18: ``dit_forget`` on DiT-XL/2 (from ``ckpt``, bf16) at batch
    DIT_BATCH + DIT_BATCH from the stand-in's shards under the CLI's mask,
    packed (adaga, AdamW 1e-4, forget clip 1.0, EMA 0.9999), with
    ``remat_policy`` ``policy``: DIT_WARMUP warm-up steps and one profiled,
    then DIT_STEPS counted and timed steps in a second call, with the
    launch counters zeroed just before and read just after. Returns (its
    numbers, the last state)."""
    import numpy as np
    import torch

    from uurg_torch.data.lazy import list_latent_shards, sharded_latent_batches
    from uurg_torch.io.dit_interop import load_dit_reference_checkpoint
    from uurg_torch.workloads import ddpm_runner
    from uurg_torch.workloads import dit_runner as DR
    from uurg_torch.workloads.dit import DiTWorkload

    wl = DiTWorkload.build(DIT_NAME, remat_policy=policy)
    model = load_dit_reference_checkpoint(ckpt, wl.init_params(SEED))
    mask = ddpm_runner.load_mask(mask_path, model)
    shards = list_latent_shards(data)
    f_it = sharded_latent_batches(shards, DIT_BATCH, seed=SEED,
                                  keep_label=lambda y: y == 0)
    r_it = sharded_latent_batches(shards, DIT_BATCH, seed=SEED + 1,
                                  keep_label=lambda y: y != 0)
    kw = dict(lr=1e-4, forget_alpha=1e-3, unlearn_loss="adaga", mask=mask,
              pack_mask=True, seed=SEED, log_freq=10 ** 6)
    tag = f"remat {policy or 'full'}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with dit_clock(DR, profile_step=DIT_WARMUP) as warm:
        DR.dit_forget(wl, model, f_it, r_it, n_iters=DIT_WARMUP + 1, **kw)
    before = {k: v.detach().clone() for k, v in model.named_parameters()
              if k in ("blocks.0.attn.qkv.weight", "final_layer.linear.weight",
                       "blocks.27.adaLN_modulation.1.weight")}
    with dit_clock(DR) as rec:
        _zero_launches()
        t0 = time.perf_counter()
        state = DR.dit_forget(wl, model, f_it, r_it, n_iters=DIT_STEPS,
                              **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_all_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = rec["loss"]
    if len(losses) != DIT_STEPS or not np.isfinite(losses + warm["loss"]).all():
        fail(f"DiT SFR-on ({tag}): losses {losses}")
    params = dict(model.named_parameters())
    ema = dict(state.ema_model.named_parameters())
    for k, v in before.items():
        if torch.equal(params[k].detach(), v) or torch.equal(ema[k], v):
            fail(f"DiT SFR-on ({tag}): {k} or its EMA did not move")
    phases = 2 * DIT_STEPS
    want = {k: 0 for k in launches}
    want["attention_fwd"] = DIT_BLOCKS * phases * (2 if policy is None else 1)
    want["attention_bwd"] = DIT_BLOCKS * phases
    _expect_launches(f"DiT SFR-on ({tag}, {DIT_STEPS} steps)", launches, want)
    step_ms = np.diff(rec["t"]) * 1e3
    med = float(np.median(step_ms))
    share = warm["busy_ms"] / med
    print(f"  {tag}: steps {np.round(step_ms, 3).tolist()} ms, median "
          f"{med:.3f} ms ({1e3 / med:.3f} steps/s), call {wall:.3f} s; "
          f"profiled step {warm['profiled_ms']:.3f} ms with {warm['busy_ms']:.3f}"
          f" ms of device work ({100 * share:.1f}% of the median step); peak "
          f"{peak:.3f} GiB; losses first {losses[0]}, last {losses[-1]}; on "
          f"{card}", flush=True)
    return ({"launches": launches, "step_ms": step_ms.tolist(),
             "median_step_ms": med, "steps_per_s": 1e3 / med,
             "busy_ms_profiled_step": warm["busy_ms"],
             "profiled_step_ms": warm["profiled_ms"],
             "busy_share_of_median": share, "peak_gib": peak,
             "call_s": wall, "losses": losses}, wl, state)


def dit_grid(wl, model, work: str, card: str) -> dict:
    """Phase 18: ``dit_sample_grid`` (DIT_GRID_STEPS respaced ancestral
    steps, CFG DIT_COND_SCALE, 2 labels of each of DIT_GRID_CLASSES
    classes) from the EMA model, one forward launch a block a step."""
    import numpy as np
    import torch

    from uurg_torch.workloads import dit_runner as DR

    out = os.path.join(work, "grid.npz")
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    DR.dit_sample_grid(wl, model, out, n_per_class=2,
                       classes=list(range(DIT_GRID_CLASSES)),
                       respacing=str(DIT_GRID_STEPS),
                       cond_scale=DIT_COND_SCALE, seed=SEED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_all_launches()
    with np.load(out) as d:
        lat = d["latents"]
    if lat.shape != (2 * DIT_GRID_CLASSES, 32, 32, 4) or \
            not np.isfinite(lat).all() or lat.std() == 0:
        fail(f"the sample grid holds {lat.shape} latents, not finite or "
             f"constant")
    _expect_launches(f"DiT sample grid ({DIT_GRID_STEPS} steps)", launches,
                     {**{k: 0 for k in launches},
                      "attention_fwd": DIT_BLOCKS * DIT_GRID_STEPS})
    print(f"  {2 * DIT_GRID_CLASSES} latents in {secs:.3f} s "
          f"({1e3 * secs / DIT_GRID_STEPS:.3f} ms a step at CFG batch "
          f"{4 * DIT_GRID_CLASSES}) on {card}", flush=True)
    return {"launches": launches, "seconds": secs}


def dit_path(card: str, gen) -> dict:
    """Phase 18: DiT-XL/2 class forgetting on pre-encoded ImageNet-256
    latents."""
    import shutil

    import torch

    from uurg_torch.core.device import resolve_device

    dev = resolve_device("cuda")           # TF32 off, as every entry point
    out = {}
    out["rows"], out["rows_f32"] = dit_attention_kernels(gen)
    out["bf16_check"] = dit_bf16_check(gen)
    torch.cuda.empty_cache()
    out["f32_check"] = dit_f32_card_vs_cpu(dev)
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="uurg_dit_")
    try:
        data = dit_stand_in(work)
        ckpt = dit_checkpoint(work)
        torch.cuda.empty_cache()
        out["clis"], mask_path = dit_clis(work, data, ckpt)
        runs = {}
        for policy in (None, "attn"):
            runs[policy or "full"], wl, state = dit_train(
                data, ckpt, mask_path, policy, card)
            if policy is None:
                del wl, state
                torch.cuda.empty_cache()
        out["train"] = runs
        out["grid"] = dit_grid(wl, state.ema_model, work, card)
        del wl, state
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    out["launches"] = {"dit_full": runs["full"]["launches"],
                       "dit_attn": runs["attn"]["launches"],
                       "dit_grid": out["grid"]["launches"]}
    return out


def xwide_attention(gen) -> dict:
    """Phase 19 (a): the float32 attention forward at head widths above 256
    (the xwide route) against the plain version, TF32 off: XWIDE_SHAPES at
    batch 2 x 1 head (relative L2 F32_FWD_REL, the log-sum-exp, three runs
    with equal bits), then XWIDE_TIMED (the VAE's VAE_ATTN_SHAPE first)
    checked the same way and timed by CUDA-graph replay and eagerly beside
    the plain version and float32 SDPA under each backend that takes the
    shape (the fastest is the library column). The bound is operations:
    4 B H T^2 D over the fp32 rate. Returns the VAE shape's row, with the
    other timed shapes under ``"timed"``."""
    import torch

    from uurg_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def check(B, H, T, D):
        q, k, v = (torch.randn(B, H, T, D, generator=gen, device="cuda")
                   for _ in range(3))
        route = FA._f32_plan(B, H, T, D).route
        if route != "xwide":
            fail(f"attention at D = {D} takes the {route} route")
        tag = f"{route} B={B} H={H} T={T} D={D}"
        o, lse = FA._attention_kernel(q, k, v, with_lse=True)
        torch.cuda.synchronize()
        err = rel_l2(f"attention {tag}", o, FA.attention_plain(q, k, v),
                     F32_FWD_REL)
        check_lse(f"attention {tag}", lse, q, k)
        for _ in range(RAGGED_REPEATS - 1):
            again = FA._attention_kernel(q, k, v, with_lse=True)
            if not (torch.equal(o, again[0]) and torch.equal(lse, again[1])):
                fail(f"attention {tag}: repeated runs differ in their bits")
        return err, (q, k, v)

    errs = [check(2, 1, T, D)[0] for T, D in XWIDE_SHAPES]
    print(f"  {len(XWIDE_SHAPES)} shapes, {RAGGED_REPEATS} runs each with "
          f"equal bits", flush=True)
    rows = []
    for B, H, T, D in XWIDE_TIMED:
        err, (q, k, v) = check(B, H, T, D)
        ms, eager = time_ms(lambda: FA._attention_kernel(q, k, v,
                                                         with_lse=False), 10)
        plain_ms = time_ms(lambda: FA.attention_plain(q, k, v), 10)[0]
        sdpa = sdpa_by_backend(q, k, v)
        fastest = min(sdpa, key=sdpa.get)
        n = B * H * T * D
        bytes_ms = 4 * n * 4 / HBM_BYTES_PER_S * 1e3
        # operations at the design's rate: three TF32 tensor-core products
        # for each of the two (4 B H T^2 D); beside it the FFMA rate's
        ops_ms = 3 * 4 * n * T / TF32_TC_FLOPS * 1e3
        ffma_ops_ms = 4 * n * T / FP32_FLOPS * 1e3
        rows.append({
            "name": "attention_fwd_f32", "route": "xwide",
            "shape": {"B": B, "H": H, "T": T, "D": D}, "ms": ms,
            "eager_ms": eager, "plain_ms": plain_ms,
            "library_ms": sdpa[fastest], "library_backend": fastest,
            "sdpa_ms": sdpa, "sdpa_default": sdpa_backend_names(q, k, v),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "ffma_ops_ms": ffma_ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "ffma_bound_ms": max(bytes_ms, ffma_ops_ms),
            "kernels_per_call": kernels_a_call(
                lambda: FA._attention_kernel(q, k, v, with_lse=False)),
            "max_abs_err": max(errs + [err])})
        r = rows[-1]
        print(f"  attention_fwd_f32 (xwide) {r['shape']}: kernel {ms:.4f} ms "
              f"(eager {eager:.4f} ms), plain {plain_ms:.4f} ms, fp32 SDPA "
              + ", ".join(f"{b} {t:.4f}" for b, t in sdpa.items())
              + f" ms (fastest {fastest}; by default {r['sdpa_default']}), "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: three TF32 "
              f"products; at the FFMA rate {r['ffma_bound_ms']:.4f} ms), "
              f"{r['kernels_per_call']} kernel(s) a call", flush=True)
        del q, k, v
    return {**rows[0], "timed": rows[1:]}


def xwide_width_path(card: str, gen) -> dict:
    """The width phase: the xwide kernels at padded widths 320-512 in both
    dtypes, forward and backward, against their plain versions (float32:
    relative L2 F32_FWD_REL / F32_BWD_REL; bf16: ATOL / RTOL forward,
    BWD_REL_L2 backward), three runs with equal bits and one count a call on
    the route's counter; timed at the wide CondUNet's and the VAE's shapes
    beside the plain version and SDPA; then the CondUNet at model.ch 256
    (every attention site on the bf16 xwide route) and a gradient through
    the VAE's width-512 attention (the float32 xwide backward), each
    against its plain path, with the launches counted."""
    import torch
    import torch.nn.functional as F

    from uurg_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    A, AB = FA.attention, FA.attention_bwd

    def counters(dtype):
        return (("launches_f32", "launches_f32") if dtype == torch.float32
                else ("launches_xwide", "launches_xwide"))

    def check(B, H, T, D, dtype, lse_too: bool = True):
        q, k, v, g = (torch.randn(B, H, T, D, generator=gen, device="cuda",
                                  dtype=dtype) for _ in range(4))
        fname, bname = counters(dtype)
        if FA._kernel_width(q) not in FA._XWIDE_D:
            fail(f"attention at D = {D} does not take the xwide route")
        tag = f"xwide {str(dtype)[6:]} B={B} H={H} T={T} D={D}"
        outs = []
        for _ in range(RAGGED_REPEATS):
            f0, b0 = getattr(A, fname), getattr(AB, bname)
            o, lse = FA._attention_kernel(q, k, v, with_lse=True)
            grads = FA.attention_bwd(q, k, v, o, lse, g)
            if (getattr(A, fname) - f0, getattr(AB, bname) - b0) != (1, 1):
                fail(f"attention {tag}: not one launch a call on "
                     f"{fname}")
            outs.append((o, lse, *grads))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for other in outs[1:]
                   for a, b in zip(outs[0], other)):
            fail(f"attention {tag}: repeated runs differ in their bits")
        o, lse, *grads = outs[0]
        want = FA.attention_plain(q, k, v)
        if dtype == torch.float32:
            err = rel_l2(f"attention {tag}", o, want, F32_FWD_REL)
        else:
            err = compare(f"attention {tag}", o, want)
        check_lse(f"attention {tag}", lse, q, k)
        tol = F32_BWD_REL if dtype == torch.float32 else BWD_REL_L2
        err = max([err] + [rel_l2(f"attention bwd d{n} {tag}", a, b, tol)
                           for n, a, b in zip(
                               "qkv", grads,
                               FA.attention_bwd_plain(q, k, v, g))])
        return err, (q, k, v, g, o, lse)

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for D in XW_WIDTHS:
            for T in XW_TS:
                err = check(2, 1, T, D, dtype)[0]
                errs[dtype] = max(errs.get(dtype, 0.0), err)
    print(f"  {len(XW_WIDTHS) * len(XW_TS)} shapes a dtype, "
          f"{RAGGED_REPEATS} runs each with equal bits", flush=True)

    def timed(name, shape, dtype, backward):
        B, H, T, D = shape
        err, (q, k, v, g, o, lse) = check(B, H, T, D, dtype)
        n = B * H * T * D
        size = 2 if dtype == torch.bfloat16 else 4
        if backward:
            run = lambda: FA.attention_bwd(q, k, v, o, lse, g)  # noqa: E731
            plain = lambda: FA.attention_bwd_plain(q, k, v, g)  # noqa: E731
            lib, stream = library_bwd(F.scaled_dot_product_attention,
                                      (q, k, v), g)
            nbytes, ops = 7 * n * size, 10 * n * T
            backend = sdpa_backend_names(q, k, v, g)
        else:
            run = lambda: FA._attention_kernel(  # noqa: E731
                q, k, v, with_lse=False)
            plain = lambda: FA.attention_plain(q, k, v)  # noqa: E731
            lib, stream = (lambda: F.scaled_dot_product_attention(q, k, v),
                           None)
            nbytes, ops = 4 * n * size, 4 * n * T
            backend = sdpa_backend_names(q, k, v)
        ms, eager = time_ms(run, 10)
        plain_ms = time_ms(plain, 5)[0]
        lib_ms = time_ms(lib, 10, stream=stream)[0]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # operations at the design's rate: one bf16 tensor-core product, or
        # for float32 three TF32 products (3xTF32), with the FFMA rate's
        # bound beside it
        ops_ms = (ops / BF16_TC_FLOPS if dtype == torch.bfloat16
                  else 3 * ops / TF32_TC_FLOPS) * 1e3
        row = {"name": name, "shape": {"B": B, "H": H, "T": T, "D": D},
               "dtype": str(dtype)[6:], "ms": ms, "eager_ms": eager,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library_backend": backend["backend"],
               "library_kernels": backend["kernels"],
               "bytes_ms": bytes_ms, "ops_ms": ops_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "kernels_per_call": kernels_a_call(run),
               "max_abs_err": max(err, errs[dtype])}
        if dtype == torch.float32:
            row["ffma_bound_ms"] = max(bytes_ms, ops / FP32_FLOPS * 1e3)
        print(f"  {name} {row['shape']} {row['dtype']}: kernel {ms:.4f} ms "
              f"(eager {eager:.4f} ms), plain {plain_ms:.4f} ms, SDPA "
              f"{lib_ms:.4f} ms ({backend['backend']}), bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}"
              + (f"; at the FFMA rate {row['ffma_bound_ms']:.4f} ms"
                 if "ffma_bound_ms" in row else "")
              + f"), {row['kernels_per_call']} kernel(s) a call",
              flush=True)
        del q, k, v, g, o, lse
        return row

    rows = [timed("attention_fwd_xwide", XW_UNET_CFG, torch.bfloat16, False),
            timed("attention_fwd_xwide", XW_UNET_TRAIN, torch.bfloat16,
                  False),
            timed("attention_bwd_xwide", XW_UNET_TRAIN, torch.bfloat16, True),
            timed("attention_bwd_f32_xwide", VAE_ATTN_SHAPE, torch.float32,
                  True)]
    _collect()
    out = {"rows": rows, "unet": wide_unet_check(gen),
           "vae_grad": vae_grad_check(gen)}
    _collect()
    return out


def wide_unet_check(gen) -> dict:
    """The CondUNet of configs/cifar10_sfron.yml at model.ch 256 (bf16,
    seeded): its parameters and attention sites, then a forward and a
    backward at batch 8 with the kernels against its plain path (phases 4
    and 6's gates), every attention site on the bf16 xwide route."""
    from uurg_torch.ops.flash_attention import attention, attention_bwd
    from uurg_torch.workloads.ddpm import DDPMWorkload

    config = sfron_config()
    config.model.ch = WIDE_CH
    wl = DDPMWorkload.from_config(config)
    model = wl.init_params(SEED)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != WIDE_PARAMS:
        fail(f"the ch {WIDE_CH} CondUNet has {n_params} parameters, not "
             f"{WIDE_PARAMS}")
    sites = collect_sites(model, wl.device)
    attn = sorted(((s[1][1] * s[1][2], s[1][0]) for s in sites
                   if s[0] == "attn"), reverse=True)
    want = [(T, 512) for T, n in WIDE_SITES for _ in range(n)]
    if attn != want:
        fail(f"the ch {WIDE_CH} CondUNet's attention sites (T, D) are "
             f"{attn}, not {want}")
    print(f"  CondUNet ch {WIDE_CH}: {n_params} parameters, attention "
          f"sites {attn}", flush=True)
    _zero_launches()
    fwd_rel = model_check(model, gen)
    fwd = attention.launches_xwide
    grad_rel = grad_check(model, wl, gen)
    launches = {"attention_fwd_xwide": attention.launches_xwide,
                "attention_bwd_xwide": attention_bwd.launches_xwide,
                "attention_fwd": attention.launches,
                "attention_bwd": attention_bwd.launches}
    # model_check: one forward on the kernels; grad_check: one forward and
    # one backward on the kernels (its plain pass counts nothing)
    expect = {"attention_fwd_xwide": 2 * len(attn),
              "attention_bwd_xwide": len(attn),
              "attention_fwd": 0, "attention_bwd": 0}
    print(f"  launches {launches} (expected {expect}; {fwd} in the "
          f"forward check)", flush=True)
    if launches != expect or fwd != len(attn):
        fail(f"the ch {WIDE_CH} CondUNet did not run every attention site "
             f"on the xwide route")
    del model, wl
    return {"params": n_params, "sites": attn, "model_rel_l2": fwd_rel,
            "grad_rel_l2": grad_rel, "launches": launches}


def vae_grad_check(gen) -> dict:
    """The gradient of a VAE encode (VAEConfig, fp32, 256 px, batch 2) with
    respect to its images: its mid attention is one head of width 512 at
    T = 1024, whose backward takes the float32 xwide route; against the
    plain path (relative L2 VAE_REL)."""
    import torch

    from uurg_torch.models.autoencoder_kl import init_vae
    from uurg_torch.ops.flash_attention import attention_bwd

    vae = init_vae(SEED, device="cuda")
    x = torch.rand(2, VAE_RES, VAE_RES, 3, generator=gen,
                   device="cuda") * 2 - 1

    def grad():
        xl = x.detach().requires_grad_()
        (vae.encode(xl) ** 2).sum().backward()
        return xl.grad

    before = attention_bwd.launches_f32
    got = grad()
    launches = attention_bwd.launches_f32 - before
    with plain_layers():
        want = grad()
    if launches != 1:
        fail(f"a VAE encode's gradient made {launches} float32 attention "
             f"backward launches, not 1")
    err = rel_l2("VAE encode gradient, kernels vs plain path", got, want,
                 VAE_REL)
    del vae
    return {"launches": {"attention_bwd_f32_xwide": launches},
            "max_abs_err": err}


def xwide_kernel_rows(width: dict, meta: dict) -> list[dict]:
    """The ``kernels`` rows of the width phase's three entry points, a
    launch at the shape the main path gives each: the bf16 forward at the
    wide CondUNet's CFG batch, the bf16 backward at its training batch, the
    float32 backward at the VAE's batch 32; launches from the wide CondUNet
    and the VAE gradient."""
    by_name = {}
    for r in width["rows"]:
        by_name.setdefault(r["name"], r)           # the first shape of each
    launches = {**width["unet"]["launches"],
                **width["vae_grad"]["launches"]}
    out = []
    for name, counter, per in (
            ("attention_fwd_xwide", "attention_fwd",
             f"one launch at {XW_UNET_CFG} bf16 (a CondUNet model.ch "
             f"{WIDE_CH} attention at CFG batch 256)"),
            ("attention_bwd_xwide", "attention_bwd",
             f"one call (delta, key pass, dq pass) at {XW_UNET_TRAIN} bf16 "
             f"(a CondUNet model.ch {WIDE_CH} attention at training batch "
             f"128)"),
            ("attention_bwd_f32_xwide", "attention_bwd_f32",
             f"one call (delta, key pass, dq pass) at {VAE_ATTN_SHAPE} "
             f"fp32 (the VAE's attention at batch {VAE_BATCH}; bound_ms "
             f"three TF32 products, ffma_bound_ms at the FFMA rate)")):
        r = by_name[name]
        out.append({
            "name": name, "route": "cuda",
            "source": ("uurg_torch/csrc/flash_attention_xwide_fwd.cu"
                       if name == "attention_fwd_xwide" else
                       "uurg_torch/csrc/flash_attention_xwide_bwd.cu"),
            "replaces": meta[counter]["replaces"],
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            **{k: r[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms", "library_backend",
                                 "kernels_per_call", "ffma_bound_ms")
               if k in r},
            "per": per + ", device ms by CUDA-graph replay; library: SDPA "
                   "at that dtype, the backend its dispatcher picks"})
    return out


@contextlib.contextmanager
def vae_sites():
    """Record the (kind, shape) of every GroupNorm and attention call of
    the models' layers while the block runs."""
    from uurg_torch.models import layers

    sites = []
    gn, attn = layers.group_norm, layers.attention

    def rec_gn(x, *a, **kw):
        sites.append(("gn", tuple(x.shape)))
        return gn(x, *a, **kw)

    def rec_attn(q, k, v):
        sites.append(("attn", tuple(q.shape)))
        return attn(q, k, v)

    layers.group_norm, layers.attention = rec_gn, rec_attn
    try:
        yield sites
    finally:
        layers.group_norm, layers.attention = gn, attn


def vae_gn_site_counts(vae, res: int = VAE_RES) -> dict:
    """(H, W, C) of each GroupNorm site shape of the VAE's encode and decode
    at ``res`` px -> its (encode, decode) site counts, from one batch-1 pass
    of each."""
    import torch

    with torch.inference_mode(), vae_sites() as sites:
        z = vae.encode(torch.zeros(1, res, res, 3, device="cuda"))
        n_enc = len(sites)
        vae.decode(z)
    count = {}
    for i, (kind, shape) in enumerate(sites):
        if kind == "gn":
            enc, dec = count.get(shape[1:], (0, 0))
            count[shape[1:]] = (enc + (i < n_enc), dec + (i >= n_enc))
    return count


def vae_gn_sites(vae, gen) -> list[dict]:
    """Phase 19 (b): the GroupNorm forward at every fp32 site shape of the
    VAE's encode and decode at VAE_BATCH (found by one batch-1 pass of
    each), the 2^31-byte (32, 256, 256, 256) site included: y, mean and
    rstd against the plain version on the route the wrapper chooses (the
    split route), three runs with equal bits, its kernels a call counted in
    a CUDA graph of one call, timed by
    CUDA-graph replay beside the plain version and ``F.group_norm``, with
    its bound (one read of x and one write of y) and the split route's
    floor (x read twice: 1.5 times the bytes). Returns one row a site
    shape, with its sites an encode and a decode."""
    import torch
    import torch.nn.functional as F

    from uurg_torch.ops import group_norm as GN

    count = vae_gn_site_counts(vae)
    rows = []
    B = VAE_BATCH
    for (H, W, C), (enc, dec) in sorted(count.items()):
        x = torch.randn(B, H, W, C, generator=gen, device="cuda") * 2 + 0.5
        scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
        bias = torch.randn(C, generator=gen, device="cuda") * 0.2
        route = GN._fwd_route(H * W, C, 4, 32, B)
        tag = (f"group_norm B={B} H={H} W={W} C={C} fp32 ({route[0]}, "
               f"{route[1]} blocks a sample; {x.numel() * 4} bytes)")
        got = GN._group_norm_kernel(x, scale, bias, 32, 1e-6)
        torch.cuda.synchronize()
        want = GN.group_norm_plain(x, scale, bias, 32, 1e-6, True)
        err = compare(tag, got[0], want[0], GN_FP32_ATOL, GN_FP32_RTOL)
        compare(f"{tag} mean", got[1], want[1], GN_FP32_ATOL, GN_FP32_RTOL)
        compare(f"{tag} rstd", got[2], want[2], GN_RSTD_TOL, GN_RSTD_TOL)
        del want
        for _ in range(RAGGED_REPEATS - 1):
            again = GN._group_norm_kernel(x, scale, bias, 32, 1e-6)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{tag}: repeated runs differ in their bits")
            del again
        del got
        per_call = kernels_a_call(
            lambda: GN._group_norm_kernel(x, scale, bias, 32, 1e-6))
        x_nchw = x.permute(0, 3, 1, 2)
        ms, eager = time_ms(
            lambda: GN._group_norm_kernel(x, scale, bias, 32, 1e-6), 5)
        plain_ms = time_ms(
            lambda: GN.group_norm_plain(x, scale, bias, 32, 1e-6), 5)[0]
        lib_ms = time_ms(lambda: F.group_norm(x_nchw, 32, scale, bias,
                                              1e-6), 5)[0]
        nbytes = 2 * x.numel() * 4 + 2 * C * 4 + 2 * B * 32 * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 4 * x.numel() / FP32_FLOPS * 1e3
        rows.append({"name": "group_norm_fwd", "shape": {
            "B": B, "H": H, "W": W, "C": C, "G": 32}, "route": route[0],
            "cluster": route[1], "sites_encode": enc, "sites_decode": dec,
            "ms": ms, "eager_ms": eager, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "floor_ms": 1.5 * bytes_ms, "kernels_per_call": per_call,
            "max_abs_err": err})
        print(f"  group_norm_fwd {rows[-1]['shape']} x{enc} encode, x{dec} "
              f"decode: kernel {ms:.4f} ms (eager {eager:.4f} ms; {per_call} "
              f"kernels a call), plain {plain_ms:.4f} ms, F.group_norm "
              f"{lib_ms:.4f} ms, bound {rows[-1]['bound_ms']:.4f} ms (bytes; "
              f"two-read floor {1.5 * bytes_ms:.4f} ms)", flush=True)
        del x, x_nchw
        torch.cuda.empty_cache()
    if sum(r["sites_encode"] for r in rows) != VAE_GN_ENCODE or \
            sum(r["sites_decode"] for r in rows) != VAE_GN_DECODE:
        fail("the VAE's GroupNorm sites are not 22 an encode and 30 a decode")
    if not any(r["shape"]["H"] * r["shape"]["W"] * r["shape"]["C"] * 4
               * VAE_BATCH == 2 ** 31 for r in rows):
        fail("no VAE GroupNorm site of 2^31 bytes was checked")
    for key in ("ms", "library_ms", "bound_ms", "floor_ms"):
        print(f"  over an encode and a decode, {key}: "
              f"{sum(r[key] * (r['sites_encode'] + r['sites_decode']) for r in rows):.4f}",
              flush=True)
    return rows


def sd_gn_sites(gen) -> list[dict]:
    """Phase 19 (b), off the path: the GroupNorm forward at SD's bf16 UNet
    sites that fit no cluster (SD_GN_SITES) at SD_GN_BATCH, on the split
    route: y, mean and rstd against the plain version, three runs with equal
    bits, timed by CUDA-graph replay beside ``F.group_norm`` (bf16 NCHW
    view) and the bound. Returns one row a site."""
    import torch
    import torch.nn.functional as F

    from uurg_torch.ops import group_norm as GN

    rows = []
    B = SD_GN_BATCH
    for H, W, C in SD_GN_SITES:
        x = (torch.randn(B, H, W, C, generator=gen, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
        bias = torch.randn(C, generator=gen, device="cuda") * 0.2
        route = GN._fwd_route(H * W, C, 2, 32, B)
        if route[0] != "split":
            fail(f"SD's GroupNorm site {(H, W, C)} takes the {route[0]} route")
        tag = (f"group_norm B={B} H={H} W={W} C={C} bf16 (split, "
               f"{route[1]} blocks a sample)")
        got = GN._group_norm_kernel(x, scale, bias, 32, 1e-6)
        torch.cuda.synchronize()
        want = GN.group_norm_plain(x, scale, bias, 32, 1e-6, True)
        err = compare(tag, got[0], want[0])
        compare(f"{tag} mean", got[1], want[1], GN_FP32_ATOL, GN_FP32_RTOL)
        compare(f"{tag} rstd", got[2], want[2], GN_RSTD_TOL, GN_RSTD_TOL)
        for _ in range(RAGGED_REPEATS - 1):
            again = GN._group_norm_kernel(x, scale, bias, 32, 1e-6)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{tag}: repeated runs differ in their bits")
        x_nchw = x.permute(0, 3, 1, 2)
        s16, b16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        ms, eager = time_ms(
            lambda: GN._group_norm_kernel(x, scale, bias, 32, 1e-6))
        plain_ms = time_ms(
            lambda: GN.group_norm_plain(x, scale, bias, 32, 1e-6))[0]
        lib_ms = time_ms(lambda: F.group_norm(x_nchw, 32, s16, b16,
                                              1e-6))[0]
        bytes_ms = (2 * x.numel() * 2 + 2 * C * 4 + 2 * B * 32 * 4) \
            / HBM_BYTES_PER_S * 1e3
        rows.append({"name": "group_norm_fwd", "shape": {
            "B": B, "H": H, "W": W, "C": C, "G": 32}, "dtype": "bfloat16",
            "route": route[0], "cluster": route[1], "ms": ms,
            "eager_ms": eager, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bytes_ms, "bound_by": "bytes",
            "floor_ms": 1.5 * bytes_ms, "max_abs_err": err})
        print(f"  group_norm_fwd {rows[-1]['shape']} bf16, off the path: "
              f"kernel {ms:.4f} ms (eager {eager:.4f} ms), plain "
              f"{plain_ms:.4f} ms, F.group_norm {lib_ms:.4f} ms, bound "
              f"{bytes_ms:.4f} ms (bytes)", flush=True)
        if not ms < lib_ms:
            print(f"  (slower than F.group_norm at {rows[-1]['shape']})",
                  flush=True)
    return rows


def vae_model(vae, card: str, gen) -> dict:
    """Phase 19 (c): the full-width VAE (seeded init, fp32, TF32 off). A
    256 px image encoded with fixed noise and decoded on the card against
    the CPU from the same weights (latents and images within VAE_REL); then
    VAE_BATCH seeded images encoded (a posterior draw) and their latents
    decoded, each after a warm-up call, with the launch counters zeroed
    just before and read just after: exactly one float32 attention forward
    and VAE_GN_ENCODE (VAE_GN_DECODE) GroupNorm forwards, every other
    counter 0; images/s on the host clock and peak memory."""
    import copy

    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    x1 = torch.from_numpy(rng.uniform(-1, 1, (1, VAE_RES, VAE_RES, 3))
                          .astype(np.float32))
    noise1 = torch.from_numpy(rng.standard_normal(
        (1, VAE_RES // 8, VAE_RES // 8, 4)).astype(np.float32))
    cpu = copy.deepcopy(vae).to("cpu")
    out = {}
    with torch.inference_mode():
        z_card = vae.encode(x1.cuda(), noise=noise1.cuda())
        img_card = vae.decode(z_card)
        z_cpu = cpu.encode(x1, noise=noise1)
        img_cpu = cpu.decode(z_cpu)
    del cpu
    out["latents_max_abs_err"] = rel_l2("VAE latents (fp32, card vs CPU, batch "
                                   "1, 256 px)", z_card.cpu(), z_cpu,
                                   VAE_REL, "the CPU")
    out["images_max_abs_err"] = rel_l2("VAE decoded images (fp32, card vs CPU)",
                                  img_card.cpu(), img_cpu, VAE_REL, "the CPU")
    x = torch.rand(VAE_BATCH, VAE_RES, VAE_RES, 3, generator=gen,
                   device="cuda") * 2 - 1
    for kind in ("encode", "decode"):
        with torch.inference_mode():
            if kind == "encode":
                def call():
                    return vae.encode(x, generator=gen)
            else:
                lat = z.clone()

                def call():
                    return vae.decode(lat)
            call()                                        # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_launches()
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = _read_all_launches()
        want_shape = ((VAE_BATCH, VAE_RES // 8, VAE_RES // 8, 4)
                      if kind == "encode" else (VAE_BATCH, VAE_RES, VAE_RES,
                                                3))
        if tuple(res.shape) != want_shape or not torch.isfinite(res).all() \
                or res.std() == 0:
            fail(f"VAE {kind}: {tuple(res.shape)}, not finite or constant")
        if kind == "encode":
            z = res
        _expect_launches(f"VAE {kind} (batch {VAE_BATCH})", launches,
                         {**{k: 0 for k in launches},
                          "attention_fwd_f32": 1,
                          "group_norm_fwd": (VAE_GN_ENCODE if kind == "encode"
                                             else VAE_GN_DECODE)})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[kind] = {"launches": launches, "seconds": secs,
                     "images_per_s": VAE_BATCH / secs, "peak_gib": peak}
        print(f"  VAE {kind} at batch {VAE_BATCH}, {VAE_RES} px: "
              f"{secs:.4f} s, {VAE_BATCH / secs:.3f} images/s, peak "
              f"{peak:.3f} GiB on {card}", flush=True)
    return out


def vae_png_folder(work: str) -> str:
    """VAE_PNG_CLASSES x VAE_PNG_EACH seeded noise PNGs, a subdirectory a
    class, of varying size around VAE_RES (the center crop cuts them)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED)
    root = os.path.join(work, "images")
    for c in range(VAE_PNG_CLASSES):
        os.makedirs(os.path.join(root, f"n{c:02d}"))
        for i in range(VAE_PNG_EACH):
            h, w = VAE_RES + 8 * (i % 5), VAE_RES + 16 * (c % 3)
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(root, f"n{c:02d}",
                                                   f"{i:03d}.png"))
    return root


def _forget_losses(argv: list[str]) -> tuple[list, dict, float]:
    """``uurg_torch.cli.forget.main(argv)`` in this process (log lines kept),
    with the launch counters zeroed before and read after: (the logged
    losses, the counters, seconds)."""
    import io
    import logging
    import re

    import torch

    from uurg_torch.cli import forget

    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)
    try:
        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        forget.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _read_all_launches()
    finally:
        logging.getLogger().removeHandler(handler)
    losses = [(float(a), float(b)) for a, b in re.findall(
        r"step \d+ forget (\S+) remain (\S+)", buf.getvalue())]
    return losses, launches, secs


def vae_entry_points(work: str, vae_file: str, card: str) -> dict:
    """Phase 19 (d): the VAE's entry points at full width on a seeded PNG
    folder. ``encode_latents`` (in this process, launches counted: one
    float32 attention forward and VAE_GN_ENCODE GroupNorm forwards a batch
    of VAE_BATCH) into shards, whose labels and order must be the folder's;
    ``forget`` one step at batch VAE_FORGET_BATCH from those shards and
    one from the image folder itself (the VAE in the loop: one encode of
    each stream), both from the perturbed DiT-XL/2 ``.pt`` of phase 18
    with the VAE file; then ``python -m uurg_torch.cli.dit_sample --mode
    fid_npz`` (VAE_FID_SAMPLES labels, 32 a batch, VAE_SAMPLE_STEPS
    respaced steps): a (64, 256, 256, 3) uint8 npz, not constant."""
    import gc
    import shutil

    import numpy as np
    import torch

    from uurg_torch.cli import encode_latents
    from uurg_torch.data.lazy import LazyImageFolder, list_latent_shards

    out = {"launches": {}}
    png = vae_png_folder(work)
    ckpt = dit_checkpoint(work)
    lat = os.path.join(work, "latents", "shard")
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    encode_latents.main(["--image_folder", png, "--out", lat, "--image_size",
                         str(VAE_RES), "--batch_size", str(VAE_BATCH),
                         "--shard_size", str(VAE_BATCH), "--vae_ckpt",
                         vae_file])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_all_launches()
    n_img = VAE_PNG_CLASSES * VAE_PNG_EACH
    batches = -(-n_img // VAE_BATCH)
    _expect_launches("encode_latents", launches,
                     {**{k: 0 for k in launches},
                      "attention_fwd_f32": batches,
                      "group_norm_fwd": VAE_GN_ENCODE * batches})
    out["launches"]["encode_latents"] = launches
    shards = list_latent_shards(os.path.dirname(lat))
    zs, ys = [], []
    for path in shards:
        with np.load(path) as d:
            zs.append(d["latents"])
            ys.append(d["labels"])
    zs, ys = np.concatenate(zs), np.concatenate(ys)
    if len(shards) != batches or \
            zs.shape != (n_img, VAE_RES // 8, VAE_RES // 8, 4) or \
            not np.isfinite(zs).all() or \
            not np.array_equal(ys, LazyImageFolder(png, VAE_RES).labels):
        fail(f"encode_latents wrote {len(shards)} shards of {zs.shape} "
             f"latents, not finite or out of the folder's order")
    out["encode_latents_s"] = secs
    print(f"  encode_latents: {n_img} images in {secs:.3f} s "
          f"({n_img / secs:.3f} images/s with PNG decoding), {len(shards)} "
          f"shards of {VAE_BATCH}; launches {launches}", flush=True)
    common = ["--ckpt", ckpt, "--n-iters", "1", "--global-batch-size",
              str(VAE_FORGET_BATCH), "--snapshot-every", "10",
              "--ckpt-every", "10", "--log-every", "1"]
    for tag, data, extra in (("shards", os.path.dirname(lat), []),
                             ("image_folder", png, ["--vae_ckpt", vae_file])):
        results = os.path.join(work, f"results_{tag}")
        losses, launches, secs = _forget_losses(
            ["--data-path", data, *extra, *common, "--results-dir", results])
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  forget from the {tag.replace('_', ' ')}: {secs:.3f} s, "
              f"losses {losses}; launches {launches}", flush=True)
        if len(losses) != 1 or not np.isfinite(losses).all():
            fail(f"forget from the {tag}: logged losses {losses}")
        if not os.path.exists(os.path.join(results, "forget_0", "final.pt")):
            fail(f"forget from the {tag} wrote no final.pt")
        vae_calls = 2 if tag == "image_folder" else 0   # one a stream
        if launches["attention_fwd_f32"] != vae_calls or \
                launches["group_norm_fwd"] != VAE_GN_ENCODE * vae_calls:
            fail(f"forget from the {tag}: the VAE ran {launches}")
        out[f"forget_{tag}"] = {"losses": losses, "seconds": secs,
                                "launches": launches}
        out["launches"][f"forget_{tag}"] = launches
        shutil.rmtree(results)
    sample_dir = os.path.join(work, "samples")
    secs, _, _ = run_cli("dit_sample", [
        "--mode", "fid_npz", "--ckpt", ckpt, "--vae-ckpt", vae_file,
        "--num-fid-samples", str(VAE_FID_SAMPLES), "--per-proc-batch-size",
        str(VAE_BATCH), "--num-sampling-steps", str(VAE_SAMPLE_STEPS),
        "--cfg-scale", str(DIT_COND_SCALE), "--sample-dir", sample_dir])
    with np.load(os.path.join(sample_dir, "samples_0.npz")) as d:
        imgs, labels = d["arr_0"], d["labels"]
    if imgs.dtype != np.uint8 or \
            imgs.shape != (VAE_FID_SAMPLES, VAE_RES, VAE_RES, 3) or \
            imgs.std() == 0 or \
            not np.array_equal(labels, np.arange(VAE_FID_SAMPLES)):
        fail(f"dit_sample wrote {imgs.dtype} {imgs.shape} images (std "
             f"{imgs.std():.3f}) for labels {labels[:8]}..")
    out["dit_sample"] = {"seconds": secs, "image_mean": float(imgs.mean()),
                         "image_std": float(imgs.std())}
    print(f"  dit_sample --mode fid_npz: {imgs.shape} uint8, mean "
          f"{imgs.mean():.2f} std {imgs.std():.2f}, in {secs:.3f} s on "
          f"{card}", flush=True)
    return out


def vae_path(card: str, gen) -> dict:
    """Phase 19: DiT's frozen VAE on the card."""
    import shutil

    import torch

    from uurg_torch.core.device import resolve_device
    from uurg_torch.io.vae_interop import save_vae
    from uurg_torch.models.autoencoder_kl import init_vae

    dev = resolve_device("cuda")           # TF32 off, as every entry point
    out = {"xwide": xwide_attention(gen)}
    vae = init_vae(SEED, device=dev)
    out["parameters"] = sum(p.numel() for p in vae.parameters())
    out["gn_sites"] = vae_gn_sites(vae, gen)
    out["sd_gn_sites"] = sd_gn_sites(gen)
    out["model"] = vae_model(vae, card, gen)
    work = tempfile.mkdtemp(prefix="uurg_vae_")
    try:
        vae_file = os.path.join(work, "vae.pt")
        save_vae(vae_file, vae)
        del vae
        torch.cuda.empty_cache()
        out["entry_points"] = vae_entry_points(work, vae_file, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    out["launches"] = {"vae_encode": out["model"]["encode"]["launches"],
                       "vae_decode": out["model"]["decode"]["launches"],
                       **out["entry_points"]["launches"]}
    return out


def vae_kernel_rows(vae: dict, meta: dict) -> list[dict]:
    """The ``kernels`` rows of the frozen VAE (phase 19): the float32
    forward at width 512 a launch, GroupNorm summed over an encode and a
    decode at VAE_BATCH; launches over phase 19's main-path runs.
    ``meta``: each counter's source and the TPU kernel it replaces."""
    rows = []
    gn_rows = vae["gn_sites"]
    for name, counter, rows_k, weights, per in (
            ("attention_fwd_f32_vae", "attention_fwd_f32", [vae["xwide"]],
             [1], f"one launch at {VAE_ATTN_SHAPE} fp32 (a VAE mid-block "
             f"attention at batch {VAE_BATCH}, {VAE_RES} px; the xwide "
             f"route; bound: three TF32 products, as the kernel does them, "
             f"and ffma_bound_ms at the FFMA rate), device ms by CUDA-graph "
             f"replay; library: fp32 SDPA, its fastest backend at this "
             f"shape"),
            ("group_norm_fwd_vae", "group_norm_fwd", gn_rows,
             [r["sites_encode"] + r["sites_decode"] for r in gn_rows],
             f"a VAE encode and decode at batch {VAE_BATCH}, {VAE_RES} px "
             f"({VAE_GN_ENCODE} + {VAE_GN_DECODE} calls, fp32, on the split "
             f"route; kernels_per_call counted in a CUDA graph of one call "
             f"at each site shape): the sum over the sites of the "
             f"device ms per call (CUDA-graph replay); library: "
             f"F.group_norm")):
        def total(k, rows_k=rows_k, weights=weights):
            return sum(r[k] * w for r, w in zip(rows_k, weights))

        paths = {p: got[counter] for p, got in vae["launches"].items()}
        per_call = sorted({r["kernels_per_call"] for r in rows_k})
        rows.append({
            "name": name, "route": "cuda", "source": meta[counter]["source"],
            "replaces": meta[counter]["replaces"],
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": max(r["max_abs_err"] for r in rows_k),
            **{k: total(k) for k in ("ms", "eager_ms", "plain_ms",
                                     "library_ms")},
            "bound_ms": max(total("bytes_ms"), total("ops_ms")),
            "bound_by": ("bytes" if total("bytes_ms") >= total("ops_ms")
                         else "operations"), "per": per,
            "kernels_per_call": per_call[0] if len(per_call) == 1
            else per_call})
    rows[0]["library_backend"] = vae["xwide"]["library_backend"]
    rows[0]["ffma_bound_ms"] = vae["xwide"]["ffma_bound_ms"]
    return rows


def sd_sites(model) -> tuple[list, list]:
    """(attention calls, GroupNorm calls) of one SD UNet forward at batch
    1: each attention dispatcher call's (T, D) and each GroupNorm32 site's
    (C, H, W), groups, read by hooks."""
    import torch

    from uurg_torch.models import layers
    from uurg_torch.models import sd_unet as TU

    attn, gn, hooks = [], [], []
    for m in model.modules():
        if isinstance(m, layers.GroupNorm32):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: gn.append(
                    ("gn", tuple(args[0].shape[1:]), mod.num_groups))))
    kernel = TU.attention

    def counted(q, k, v):
        attn.append(tuple(q.shape[2:]))
        return kernel(q, k, v)

    TU.attention = counted
    try:
        with torch.inference_mode():
            model(torch.zeros(1, SD_LATENT, SD_LATENT, 4, device="cuda"),
                  torch.tensor([500], device="cuda"),
                  torch.zeros(1, *SD_CONTEXT, device="cuda"))
    finally:
        TU.attention = kernel
        for h in hooks:
            h.remove()
    if len(attn) != SD_ATTN_SITES or len(gn) != SD_UNET_GN_SITES:
        fail(f"the SD UNet made {len(attn)} attention and {len(gn)} GroupNorm "
             f"calls a forward, not {SD_ATTN_SITES} and {SD_UNET_GN_SITES}")
    return attn, gn


def sd_attention_kernels(attn_sites, gen) -> list[dict]:
    """Phase 20 (a): the bf16 attention kernels at each of the SD UNet's
    (T, D) at batch SD_BATCH x SD_HEADS heads on CrossAttention's layout
    (q, k, v, g the (B, H, T, D) views of (B, T, H D) tensors): the forward
    with and without its log-sum-exp, the log-sum-exp, the backward against
    the plain versions, three runs with equal bits, the same bits on
    contiguous copies; the kernel, the plain version and bf16 SDPA (and
    their backwards) timed by CUDA-graph replay beside the bound. One row a
    shape and direction, per launch, with its sites a UNet pass."""
    import torch
    import torch.nn.functional as F

    from uurg_torch.ops import flash_attention as FA

    rows = []
    for (T, D) in sorted(set(attn_sites), reverse=True):
        count = attn_sites.count((T, D))
        B, H = SD_BATCH, SD_HEADS
        views = tuple(torch.randn(B, T, H * D, generator=gen, device="cuda",
                                  dtype=torch.bfloat16)
                      .reshape(B, T, H, D).transpose(1, 2) for _ in range(4))
        q, k, v, g = views
        tag = f"B={B} H={H} T={T} D={D}"

        def run(q, k, v, g):
            o, lse = FA._attention_kernel(q, k, v, with_lse=True)
            with torch.no_grad():
                sample = FA.attention(q, k, v)
            return (o, lse, sample, *FA.attention_bwd(q, k, v, o, lse, g))

        first = run(*views)
        torch.cuda.synchronize()
        o, lse, sample = first[:3]
        plain = FA.attention_plain(q, k, v)
        fwd_err = max(compare(f"attention {tag}", o, plain),
                      compare(f"attention, no lse, {tag}", sample, plain))
        check_lse(f"attention {tag}", lse, q, k)
        bwd_err = max(rel_l2(f"attention bwd d{n} {tag}", a, b, BWD_REL_L2)
                      for n, a, b in zip("qkv", first[3:],
                                         FA.attention_bwd_plain(q, k, v, g)))
        del plain
        for _ in range(RAGGED_REPEATS - 1):
            if not all(torch.equal(a, b) for a, b in zip(run(*views), first)):
                fail(f"attention {tag}: repeated runs differ in their bits")
        if not all(torch.equal(a, b) for a, b in
                   zip(run(*(t.contiguous() for t in views)), first)):
            fail(f"attention {tag}: the views and contiguous copies differ "
                 f"in their bits")
        print(f"  attention {tag}: {RAGGED_REPEATS} runs with equal bits, "
              f"the same bits on contiguous copies; SDPA kernels: "
              f"{sdpa_backend_names(q, k, v, g)}", flush=True)
        lib, stream = library_bwd(F.scaled_dot_product_attention, (q, k, v),
                                  g)
        times = {
            "fwd": (time_ms(lambda: FA._attention_kernel(q, k, v,
                                                         with_lse=True)),
                    time_ms(lambda: FA.attention_plain(q, k, v), 5)[0],
                    time_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v))[0]),
            "bwd": (time_ms(lambda: FA.attention_bwd(q, k, v, o, lse, g)),
                    time_ms(lambda: FA.attention_bwd_plain(q, k, v, g),
                            5)[0],
                    time_ms(lib, stream=stream)[0])}
        nolse_ms = time_ms(lambda: FA._attention_kernel(q, k, v,
                                                        with_lse=False))[0]
        n = B * H * T * D
        for kind, nbytes, ops, err in (("fwd", 4 * n * 2, 4 * n * T,
                                        fwd_err),
                                       ("bwd", 7 * n * 2, 10 * n * T,
                                        bwd_err)):
            (ms, eager), plain_ms, lib_ms = times[kind]
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / BF16_TC_FLOPS * 1e3
            row = {"name": f"attention_{kind}",
                   "shape": {"B": B, "H": H, "T": T, "D": D},
                   "sites_per_forward": count, "ms": ms, "eager_ms": eager,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                   "max_abs_err": err}
            if kind == "fwd":
                row["no_lse_ms"] = nolse_ms
            rows.append(row)
            print(f"  attention_{kind} {row['shape']} x{count}/pass: kernel "
                  f"{ms:.4f} ms (eager {eager:.4f} ms"
                  + (f"; no lse {nolse_ms:.4f} ms" if kind == "fwd" else "")
                  + f"), plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms "
                  f"({ms / lib_ms:.2f}x), bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}; {row['bound_ms'] / ms:.1%} of it)",
                  flush=True)
        del views, q, k, v, g, first, o, lse, sample, lib
        torch.cuda.empty_cache()
    return rows


def sd_gn_repeats(gn_sites, gen) -> None:
    """Phase 20 (a): the GroupNorm forward (y, mean, rstd) and backward
    (dx, dscale, dbias) at each of the SD UNet's bf16 site shapes at
    SD_BATCH, three runs with equal bits on the wrapper's routes."""
    import torch

    from uurg_torch.ops.group_norm import group_norm, group_norm_bwd

    for _, (C, H, W), groups in sorted(set(gn_sites)):
        x = (torch.randn(SD_BATCH, H, W, C, generator=gen, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        g = torch.randn(SD_BATCH, H, W, C, generator=gen,
                        device="cuda").to(torch.bfloat16)
        scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
        bias = torch.randn(C, generator=gen, device="cuda") * 0.2

        def run():
            y, mean, rstd = group_norm(x, scale, bias, groups=groups,
                                       return_stats=True)
            return (y, mean, rstd, *group_norm_bwd(x, scale, mean, rstd, g))

        first = run()
        for _ in range(RAGGED_REPEATS - 1):
            if not all(torch.equal(a, b) for a, b in zip(run(), first)):
                fail(f"GroupNorm B={SD_BATCH} H={H} W={W} C={C}: repeated "
                     f"runs differ in their bits")
    print(f"  GroupNorm forward and backward at the "
          f"{len(set(gn_sites))} site shapes: {RAGGED_REPEATS} runs with "
          f"equal bits each", flush=True)


def sd_split_bwd_line(gn_bwd_rows) -> dict:
    """The GroupNorm backward's ``split`` sites of phase 20 (a) (S runs a
    sample, two launches), summed over a UNet backward: device ms against
    ``F.group_norm``'s backward, the bound and the split's two-read floor
    (x and g read twice, dx written once: 5/3 of the bound)."""
    rows = [r for r in gn_bwd_rows if r["route"] == "split"]
    out = {k: sum(r[k] * r["sites_per_forward"] for r in rows)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["floor_ms"] = 5 / 3 * out["bound_ms"]
    out.update(sites=sum(r["sites_per_forward"] for r in rows),
               shapes=[r["shape"] for r in rows],
               kernels_per_call=sorted({r["kernels_per_call"] for r in rows}),
               slower_than_library=[r["shape"] for r in rows
                                    if r["ms"] >= r["library_ms"]])
    found = sorted((r["shape"]["H"], r["shape"]["W"], r["shape"]["C"],
                    r["sites_per_forward"]) for r in rows)
    if found != sorted(SD_BWD_SPLIT_SITES):
        fail(f"SD's GroupNorm backward takes the split route at {found}, not "
             f"at SD_BWD_SPLIT_SITES")
    print(f"  GroupNorm backward on the split route (S runs a sample, two "
          f"launches) at batch {SD_BATCH}: {out['sites']} of "
          f"{SD_UNET_GN_SITES} sites a backward at {len(rows)} shapes, "
          f"{out['ms']:.4f} ms against F.group_norm backward's "
          f"{out['library_ms']:.4f} ms ({out['ms'] / out['library_ms']:.2f}x),"
          f" the bound {out['bound_ms']:.4f} ms "
          f"({out['ms'] / out['bound_ms']:.2f}x) and the two-read floor "
          f"{out['floor_ms']:.4f} ms; kernels a call "
          f"{out['kernels_per_call']}; slower than the library at "
          f"{out['slower_than_library']}", flush=True)
    for r in rows:
        print(f"    split {r['shape']} S={r['cluster']} "
              f"x{r['sites_per_forward']}: {r['ms']:.4f} ms, F.group_norm "
              f"backward {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms, floor {5 / 3 * r['bound_ms']:.4f} ms",
              flush=True)
    if out["slower_than_library"]:
        fail(f"the GroupNorm backward's split route is slower than "
             f"F.group_norm's backward at {out['slower_than_library']}")
    return out


def sd_gn_bwd_small_batches(gn_bwd_rows, gen) -> list[dict]:
    """Phase 20 (a): the GroupNorm backward's split route at SD's shapes
    that take it, at batches 1 and 2 (the runs a sample differ from batch
    4's): dx, dscale and dbias against the plain version, three runs with
    equal bits, the fold counters left zero; then two calls at batch 4
    captured in one CUDA graph, replayed, against the eager bits."""
    import torch

    from uurg_torch.ops import group_norm as GN

    shapes = [(r["shape"]["H"], r["shape"]["W"], r["shape"]["C"])
              for r in gn_bwd_rows if r["route"] == "split"]
    rows = []
    for B in (1, 2):
        for H, W, C in shapes:
            x = (torch.randn(B, H, W, C, generator=gen, device="cuda") * 2
                 + 0.5).to(torch.bfloat16)
            g = torch.randn(B, H, W, C, generator=gen,
                            device="cuda").to(torch.bfloat16)
            scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
            _, mean, rstd = GN.group_norm_plain(x, scale, scale, 32, 1e-6,
                                                True)
            route = GN._bwd_route(H * W, C, 2, 32, B)
            if route[0] != "split":
                fail(f"SD's GroupNorm site {(H, W, C)} at batch {B} takes the "
                     f"{route[0]} route backward")
            tag = f"group_norm bwd B={B} H={H} W={W} C={C} (split, {route[1]})"
            got = GN.group_norm_bwd(x, scale, mean, rstd, g)
            torch.cuda.synchronize()
            want = GN.group_norm_bwd_plain(x, scale, mean, rstd, g)
            err = max(compare(f"{tag} dx", got[0], want[0]),
                      rel_l2(f"{tag} dscale", got[1], want[1], GN_SUM_REL_L2),
                      rel_l2(f"{tag} dbias", got[2], want[2], GN_SUM_REL_L2))
            for _ in range(RAGGED_REPEATS - 1):
                again = GN.group_norm_bwd(x, scale, mean, rstd, g)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"{tag}: repeated runs differ in their bits")
            rows.append({"B": B, "H": H, "W": W, "C": C, "cluster": route[1],
                         "max_abs_err": err})
    if int(GN._fold_counters[torch.device("cuda", 0)].abs().sum()) != 0:
        fail("the GroupNorm backward left its fold counters non-zero")
    H, W, C = shapes[0]
    x, g = ((torch.randn(SD_BATCH, H, W, C, generator=gen, device="cuda")
             + 0.5).to(torch.bfloat16) for _ in range(2))
    scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
    _, mean, rstd = GN.group_norm_plain(x, scale, scale, 32, 1e-6, True)
    eager = [GN.group_norm_bwd(x, scale, mean, rstd, t) for t in (g, x)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = [GN.group_norm_bwd(x, scale, mean, rstd, t) for t in (g, x)]
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for e, c in zip(eager, captured)
               for a, b in zip(e, c)):
        fail(f"group_norm bwd B={SD_BATCH} H={H} W={W} C={C}: two calls in "
             f"one CUDA graph differ from the eager bits")
    print(f"  GroupNorm backward, split route, at {len(shapes)} shapes at "
          f"batches 1 and 2: {RAGGED_REPEATS} runs each with equal bits, the "
          f"counters left zero; two calls in one CUDA graph at batch "
          f"{SD_BATCH} equal the eager bits", flush=True)
    return rows


def _rel(got, want) -> float:
    """Relative L2 error in float64."""
    got, want = got.detach().double(), want.detach().double()
    return ((got - want).norm() / want.norm()).item()


def sd_inputs(gen):
    """(z, ctx, ctx0, t, noise) of SD_BATCH seeded samples on the card."""
    import torch

    n = SD_BATCH
    z = torch.randn(n, SD_LATENT, SD_LATENT, 4, generator=gen, device="cuda")
    ctx = torch.randn(n, *SD_CONTEXT, generator=gen, device="cuda")
    ctx0 = torch.randn(n, *SD_CONTEXT, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (n,), generator=gen, device="cuda")
    noise = torch.randn(n, SD_LATENT, SD_LATENT, 4, generator=gen,
                        device="cuda")
    return z, ctx, ctx0, t, noise


def sd_model_check(wl, unet, gen) -> dict:
    """Phase 20 (b): the full-width UNet (seeded init, bf16) at SD_BATCH on
    the card, kernels against the same model on its plain path: the
    forward (MODEL_REL_L2) and the eps loss's gradients at fixed t and
    noise (MODEL_GRAD_REL_L2, all parameters concatenated) under both remat
    policies; exact launch counts (a forward: 15 attention and 61
    GroupNorm; a remat'd backward runs each block's forward again: 30 + 15
    and 121 + 61) and peak memory."""
    import dataclasses

    import torch

    z, ctx, _, t, noise = sd_inputs(gen)
    _zero_launches()
    with torch.inference_mode():
        got = unet(z, t, ctx)
        fwd_launches = _read_all_launches()
        with plain_layers():
            want = unet(z, t, ctx)
    zero = {k: 0 for k in fwd_launches}
    _expect_launches("SD UNet forward", fwd_launches,
                     {**zero, "attention_fwd": SD_ATTN_SITES,
                      "group_norm_fwd": SD_UNET_GN_SITES})
    out = {"forward_max_abs_err": rel_l2(
        f"SD UNet batch-{SD_BATCH} bf16 forward, kernels vs plain path",
        got, want, MODEL_REL_L2, "the plain path"),
        "forward_rel_l2": _rel(got, want)}
    params = list(unet.parameters())
    base = unet.cfg
    for policy in (None, "dots"):
        unet.cfg = dataclasses.replace(base, remat=True, remat_policy=policy)

        def grads():
            loss = wl.p_losses(unet, z, ctx, t, noise)
            return torch.cat([g.float().reshape(-1) for g in
                              torch.autograd.grad(loss, params)])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        g_kernel = grads()
        torch.cuda.synchronize()
        launches = _read_all_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with plain_layers():
            g_plain = grads()
        name = "full" if policy is None else policy
        err = rel_l2(f"SD UNet batch-{SD_BATCH} bf16 gradients (eps loss, "
                     f"{name} remat), kernels vs plain path", g_kernel,
                     g_plain, MODEL_GRAD_REL_L2, "the plain path")
        _expect_launches(f"SD UNet gradients ({name} remat)", launches,
                         {**zero, "attention_fwd": 2 * SD_ATTN_SITES,
                          "attention_bwd": SD_ATTN_SITES,
                          "group_norm_fwd": 2 * SD_UNET_GN_SITES - 1,
                          "group_norm_bwd": SD_UNET_GN_SITES})
        print(f"  {name} remat: peak {peak:.3f} GiB", flush=True)
        out[name] = {"gradients_max_abs_err": err,
                     "gradients_rel_l2": _rel(g_kernel, g_plain),
                     "launches": launches, "peak_gib": peak}
        del g_kernel, g_plain
    unet.cfg = base
    torch.cuda.empty_cache()
    return out


def kernel_family(name: str) -> str:
    low = name.lower()
    return next(fam for fam, keys in SD_FAMILIES
                if any(k in low for k in keys))


def device_ms_by_family(name: str, run) -> dict:
    """The device kernels' own ms over one ``run()``, by the profiler,
    summed by kernel family (SD_FAMILIES); the families and the eight
    longest kernels printed. Where the profiler saw no kernels
    (``profiled_kernels``), the CUDA events' ms stand as one family,
    "unattributed"."""
    events, key, stream_ms = profiled_kernels(name, run)
    if not events:
        return {"unattributed": stream_ms}
    by_family: dict[str, float] = {}
    for e in events:
        fam = kernel_family(e.key)
        by_family[fam] = by_family.get(fam, 0.0) + getattr(e, key) / 1e3
    busy = sum(by_family.values())
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"    {fam:22s} {ms:10.3f} ms  {ms / busy:6.1%}", flush=True)
    for e in sorted(events, key=lambda e: -getattr(e, key))[:8]:
        print(f"    top: {getattr(e, key) / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:90]}", flush=True)
    return by_family


def sd_fisher_batch(wl, unet, gen, card: str) -> dict:
    """Phase 20 (c): one Fisher batch (``fisher_loss_fn``: two forwards at
    SD_BATCH and their backward through full remat, the squared gradient
    folded into fp32 accumulators) on the host clock over 3 batches after a
    warm-up, and its device time by kernel family from the profiler."""
    import torch

    from uurg_torch.unlearn.fisher import make_fisher_batch_step

    z, ctx, ctx0, _, _ = sd_inputs(gen)
    step = make_fisher_batch_step(wl.fisher_loss_fn(SD_FISHER_GUIDANCE))
    fisher = {n: torch.zeros_like(p) for n, p in unet.named_parameters()}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    step(fisher, unet, (z, ctx, ctx0), g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(fisher, unet, (z, ctx, ctx0), g)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / 3
    by_family = device_ms_by_family(
        "a Fisher batch", lambda: step(fisher, unet, (z, ctx, ctx0), g))
    busy = sum(by_family.values())
    print(f"  one Fisher batch (CFG-composed eps, 2 forwards + backward at "
          f"batch {SD_BATCH}, full remat): {secs:.4f} s on the host clock, "
          f"device busy {busy:.3f} ms ({busy / 1e3 / secs:.1%}) on {card}",
          flush=True)
    del fisher
    torch.cuda.empty_cache()
    return {"seconds": secs, "device_busy_ms": busy,
            "device_ms_by_family": by_family}


def sd_png_folders(work: str) -> tuple[str, str]:
    """Two seeded PNG folders (nsfw and not-nsfw stand-ins, one class
    subdirectory each) of SD_PNG_EACH noise images around SD_RES px (the
    center crop cuts them)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED)
    roots = []
    for name in ("nsfw", "not-nsfw"):
        root = os.path.join(work, name)
        os.makedirs(os.path.join(root, "c0"))
        for i in range(SD_PNG_EACH):
            img = rng.integers(0, 256, (SD_RES + 8 * (i % 3),
                                        SD_RES + 16 * (i % 2), 3),
                               dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(root, "c0",
                                                   f"{i:03d}.png"))
        roots.append(root)
    return roots[0], roots[1]


def sd_fisher_cli(work: str, card: str) -> dict:
    """Phase 20 (c): ``sd_generate_fisher`` in this process, the launch
    counters zeroed just before and read just after, on SD_PNG_EACH +
    SD_PNG_EACH seeded PNGs at SD_RES px, SD_FISHER_BATCHES of its 50
    batches at SD_BATCH, threshold SD_THRESHOLD. Its three files must be
    written, the Fishers finite, non-negative and not all zero; the mask's
    sparsity printed. Launches: a Fisher batch is two forwards and their
    remat'd backward; each folder is one VAE encode of its images."""
    import torch

    from uurg_torch.cli import sd_generate_fisher
    from uurg_torch.io.checkpoint import restore_checkpoint
    from uurg_torch.models.clip_text import active_tokenizer
    from uurg_torch.unlearn.saliency import mask_sparsity

    nsfw, clothed = sd_png_folders(work)
    out_dir = os.path.join(work, "fisher")
    argv = ["--nsfw_data", nsfw, "--not_nsfw_data", clothed, "--n_batches",
            str(SD_FISHER_BATCHES), "--batch_size", str(SD_BATCH),
            "--image_size", str(SD_RES), "--threshold", str(SD_THRESHOLD),
            "--seed", str(SEED), "--save_path", out_dir]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    sd_generate_fisher.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_all_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    batches = 2 * SD_FISHER_BATCHES
    encodes = 2 * -(-SD_PNG_EACH // 8)             # encode_image_folder's 8
    _expect_launches("sd_generate_fisher", launches, {
        **{k: 0 for k in launches},
        "attention_fwd": batches * 4 * SD_ATTN_SITES,
        "attention_bwd": batches * 2 * SD_ATTN_SITES,
        "group_norm_fwd": batches * 2 * (2 * SD_UNET_GN_SITES - 1)
        + encodes * VAE_GN_ENCODE,
        "group_norm_bwd": batches * 2 * SD_UNET_GN_SITES,
        "attention_fwd_f32": encodes})
    files = sorted(os.listdir(out_dir))
    want = ["nude_forget", f"nude_mask_{SD_THRESHOLD}", "nude_remain"]
    if files != want:
        fail(f"sd_generate_fisher wrote {files}, not {want}")
    stats = {}
    for name in ("forget", "remain"):
        fisher = restore_checkpoint(os.path.join(out_dir, f"nude_{name}"))
        flat = torch.cat([v.reshape(-1) for v in fisher.values()])
        if not (torch.isfinite(flat).all() and flat.min() >= 0
                and flat.max() > 0):
            fail(f"the {name} Fisher is not finite, non-negative and "
                 f"non-zero")
        stats[name] = {"leaves": len(fisher),
                       "sum": float(flat.double().sum()),
                       "nonzero": float((flat > 0).double().mean())}
        del fisher, flat
    mask = restore_checkpoint(os.path.join(out_dir,
                                           f"nude_mask_{SD_THRESHOLD}"))
    sparsity = mask_sparsity(mask)
    sizes = {f: os.path.getsize(os.path.join(out_dir, f)) for f in files}
    print(f"  sd_generate_fisher ({batches} Fisher batches of batch "
          f"{SD_BATCH}, {SD_PNG_EACH} + {SD_PNG_EACH} PNGs at {SD_RES} px, "
          f"tokenizer {active_tokenizer()}): {secs:.3f} s, peak {peak:.3f} "
          f"GiB on {card}; files {sizes}; Fishers {stats}; mask "
          f"{SD_THRESHOLD} sparsity {sparsity:.4%}", flush=True)
    return {"seconds": secs, "launches": launches, "peak_gib": peak,
            "files": sizes, "fishers": stats, "mask_sparsity": sparsity,
            "tokenizer": active_tokenizer()}


def sd_samplers(wl, unet, gen, card: str) -> dict:
    """Phase 20 (d): ``make_sampler`` with ddim, plms and lms at
    SD_SAMPLE_STEPS steps, guidance SD_GUIDANCE, on SD_PROMPTS prompts (one
    batched CFG double forward a step, batch 2 x SD_PROMPTS), the latents
    decoded by the VAE at SD_RES px: launch counters zeroed just before
    and read just after (15 attention and 61 GroupNorm forwards a UNet
    forward, the decode's 30 GroupNorm and one float32 attention), finite
    images, images/s on the host clock."""
    import torch

    prompts = ["a photo of a nude person", "a photo of a person wearing "
               "clothes", "a photo of a church", "a photo of a parachute"]
    ctx = wl.get_learned_conditioning(prompts[:SD_PROMPTS])
    out = {}
    for method, forwards in SD_SAMPLER_FORWARDS.items():
        sample = wl.make_sampler(num_steps=SD_SAMPLE_STEPS,
                                 guidance_scale=SD_GUIDANCE,
                                 latent_size=SD_LATENT, method=method)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        lat = sample(unet, ctx, generator=g)
        with torch.inference_mode():
            imgs = wl.vae.decode(lat)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _read_all_launches()
        _expect_launches(f"make_sampler {method}", launches, {
            **{k: 0 for k in launches},
            "attention_fwd": forwards * SD_ATTN_SITES,
            "group_norm_fwd": forwards * SD_UNET_GN_SITES + VAE_GN_DECODE,
            "attention_fwd_f32": 1})
        if tuple(imgs.shape) != (SD_PROMPTS, SD_RES, SD_RES, 3) \
                or not torch.isfinite(imgs).all() or imgs.std() == 0:
            fail(f"make_sampler {method}: images {tuple(imgs.shape)} not "
                 f"finite or constant")
        out[method] = {"seconds": secs, "images_per_s": SD_PROMPTS / secs,
                       "launches": launches,
                       "latent_std": float(lat.std()),
                       "image_mean": float(imgs.mean()),
                       "image_std": float(imgs.std())}
        print(f"  make_sampler {method}: {SD_SAMPLE_STEPS} steps, "
              f"{forwards} UNet forwards at batch {2 * SD_PROMPTS}, decode at "
              f"{SD_RES} px: {secs:.3f} s, {SD_PROMPTS / secs:.3f} images/s "
              f"on {card}; images finite, mean {imgs.mean().item():.3f} "
              f"std {imgs.std().item():.3f}", flush=True)
    return out


def sd_path(card: str, gen, work: str) -> dict:
    """Phase 20: Stable Diffusion on the card; ``sd_generate_fisher``
    writes its PNG folders and Fishers under ``work``, which phase 21
    reads."""
    import torch

    from uurg_torch.core.device import resolve_device
    from uurg_torch.models.autoencoder_kl import init_vae
    from uurg_torch.models.clip_text import init_clip_text
    from uurg_torch.workloads.sd import SDWorkload

    dev = resolve_device("cuda")           # TF32 off, as every entry point
    wl = SDWorkload.build(device=dev)
    t0 = time.perf_counter()
    unet = wl.init_unet(SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in unet.parameters())
    print(f"  SD UNet: {n_params} parameters (CompVis v1: 859,520,964), "
          f"seeded init on the card in {time.perf_counter() - t0:.3f} s",
          flush=True)
    attn_sites, gn_sites = sd_sites(unet)
    out = {"parameters": n_params,
           "attention_sites": sorted(set(attn_sites)),
           "gn_site_shapes": len(set(gn_sites))}
    out["attention_rows"] = sd_attention_kernels(attn_sites, gen)
    out["gn_fwd_rows"] = check_kernels(gn_sites, SD_BATCH, gen)
    out["gn_bwd_rows"] = check_bwd_kernels(gn_sites, SD_BATCH, gen)
    sd_gn_repeats(gn_sites, gen)
    out["gn_bwd_split"] = sd_split_bwd_line(out["gn_bwd_rows"])
    out["gn_bwd_small_batches"] = sd_gn_bwd_small_batches(out["gn_bwd_rows"],
                                                          gen)
    out["model"] = sd_model_check(wl, unet, gen)
    out["fisher_batch"] = sd_fisher_batch(wl, unet, gen, card)
    wl.vae = init_vae(1, wl.vae_cfg, dev)
    wl.text = init_clip_text(2, wl.text_cfg, dev)
    out["samplers"] = sd_samplers(wl, unet, gen, card)
    del unet, wl
    torch.cuda.empty_cache()
    out["cli"] = sd_fisher_cli(work, card)
    torch.cuda.empty_cache()
    out["launches"] = {"sd_generate_fisher": out["cli"]["launches"],
                       **{f"sd_{m}": s["launches"]
                          for m, s in out["samplers"].items()}}
    return out


def sd_launches(grad_passes: int = 0, forwards: int = 0,
                xattn_passes: int = 0) -> dict:
    """The four kernels' launches of SD UNet passes under full remat: a
    forward with its backward runs each block's forward again in the
    recompute (``norm_out``, outside the blocks, is not recomputed); a
    forward under ``no_grad`` runs each site once. Under ``xattn`` (every
    parameter but the attn2 projections frozen with ``requires_grad``
    off) the first resnet block sees no gradient and is neither recomputed
    nor differentiated, and the first transformer block is recomputed but
    not differentiated below its attn2: 2 GroupNorm and no attention
    launches fewer in the recompute, 3 GroupNorm and 1 attention fewer in
    the backward."""
    a, g = SD_ATTN_SITES, SD_UNET_GN_SITES
    return {"attention_fwd": 2 * a * (grad_passes + xattn_passes)
            + a * forwards,
            "attention_bwd": a * grad_passes + (a - 1) * xattn_passes,
            "group_norm_fwd": (2 * g - 1) * grad_passes + g * forwards
            + (2 * g - 3) * xattn_passes,
            "group_norm_bwd": g * grad_passes + (g - 3) * xattn_passes,
            "attention_fwd_f32": 0, "attention_bwd_f32": 0}


def _plus(a: dict, b: dict) -> dict:
    return {k: a[k] + b.get(k, 0) for k in a}


def sd_mask_cli(work: str) -> dict:
    """Phase 21 (a): ``generate_fisher_mask`` in process on the Fisher
    folder ``sd_generate_fisher`` wrote: its ``nude_mask_<th>`` must be the
    same bits as the mask the Fisher CLI wrote from the same Fishers."""
    import torch

    from uurg_torch.cli import generate_fisher_mask
    from uurg_torch.io.checkpoint import restore_checkpoint

    folder = os.path.join(work, "fisher")
    path = os.path.join(folder, f"nude_mask_{SD_THRESHOLD}")
    first = restore_checkpoint(path)
    t0 = time.perf_counter()
    generate_fisher_mask.main(["--ckpt_folder", folder, "--threshold",
                               str(SD_THRESHOLD)])
    secs = time.perf_counter() - t0
    again = restore_checkpoint(path)
    if set(again) != set(first) or not all(
            again[k].dtype == torch.bool and torch.equal(again[k], first[k])
            for k in first):
        fail("generate_fisher_mask's SD mask differs from sd_generate_fisher's")
    for name in ("nude_forget", "nude_remain"):        # 3.44 GB each
        os.remove(os.path.join(folder, name))
    print(f"  generate_fisher_mask (SD layout, threshold {SD_THRESHOLD}): "
          f"{secs:.3f} s, {len(again)} leaves bit-equal to "
          f"sd_generate_fisher's mask", flush=True)
    return {"seconds": secs, "leaves": len(again)}


def _sd_batches(gen):
    """The forget (z, ctx_forget, ctx_pseudo) and remain (z, ctx_pseudo)
    batches of nsfw_removal at SD_BATCH, seeded, on the card."""
    import itertools

    z, ctx, ctx0, _, _ = sd_inputs(gen)
    z_r = z.flip(0)
    return (itertools.repeat((z, ctx, ctx0)), itertools.repeat((z_r, ctx0)))


def sd_sfron_step(card: str, mask_path: str, gen) -> dict:
    """Phase 21 (b): ``nsfw_removal`` on the full-width UNet (seeded,
    bf16, full remat) at SD_BATCH + SD_BATCH, train_method full, under the
    Fisher mask dense and packed: SD_SFRON_WARMUP warm-up steps and one
    profiled (device ms by kernel family), then SD_SFRON_TIMED counted and
    timed steps with the launch counters zeroed just before and read just
    after (a step: the forget phase's trained forward and its pseudo
    target's no_grad forward, the remain phase's trained forward); finite
    losses and weights. Then one step under xattn: every parameter outside
    the attn2 projections the same bits, Adam state for those only."""
    import numpy as np
    import torch

    from uurg_torch.io.checkpoint import restore_checkpoint
    from uurg_torch.io.sd_interop import sd_unet_key_map
    from uurg_torch.workloads import sd_runner as TR
    from uurg_torch.workloads.sd import SDWorkload

    wl = SDWorkload.build(device="cuda")
    fb, rb = _sd_batches(gen)
    out = {}
    for pack in (False, True):
        tag = "packed" if pack else "dense"
        unet = wl.init_unet(SEED)
        mask = restore_checkpoint(mask_path, like=unet)
        kw = dict(lr=1e-5, saliency_mask=mask, pack_mask=pack, seed=SEED,
                  snapshot_freq=10 ** 6)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the dense run's step after the warm-up runs under the profiler
        with dit_clock(TR, profile_step=None if pack else SD_SFRON_WARMUP,
                       families=True) as warm:
            TR.nsfw_removal(wl, unet, fb, rb,
                            n_iters=SD_SFRON_WARMUP + (not pack), **kw)
        with dit_clock(TR) as rec:
            _zero_launches()
            t0 = time.perf_counter()
            TR.nsfw_removal(wl, unet, fb, rb, n_iters=SD_SFRON_TIMED, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _read_all_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _expect_launches(f"nsfw_removal ({tag} mask, {SD_SFRON_TIMED} steps)",
                         launches, sd_launches(
                             grad_passes=2 * SD_SFRON_TIMED,
                             forwards=SD_SFRON_TIMED))
        losses = warm["loss"] + rec["loss"]
        if not np.isfinite(losses).all() or not all(
                bool(torch.isfinite(p).all()) for p in unet.parameters()):
            fail(f"nsfw_removal ({tag}): losses {losses} or weights not "
                 f"finite")
        step_ms = np.diff(rec["t"]) * 1e3
        med = float(np.median(step_ms))
        out[tag] = {"launches": launches, "step_ms": step_ms.tolist(),
                    "median_step_ms": med, "steps_per_s": 1e3 / med,
                    "peak_gib": peak, "call_s": wall, "losses": losses}
        busy = ""
        if not pack:
            out[tag].update(
                busy_ms_profiled_step=warm["busy_ms"],
                device_ms_by_family=warm["by_family"],
                profiled_step_ms=warm["profiled_ms"],
                busy_share_of_median=warm["busy_ms"] / med)
            busy = (f"; profiled step {warm['profiled_ms']:.3f} ms with "
                    f"{warm['busy_ms']:.3f} ms of device work "
                    f"({warm['busy_ms'] / med:.1%} of the median step)")
        print(f"  nsfw_removal SFR-on step ({tag} mask): steps "
              f"{np.round(step_ms, 3).tolist()} ms, median {med:.3f} ms "
              f"({1e3 / med:.3f} steps/s), call {wall:.3f} s{busy}; peak "
              f"{peak:.3f} GiB; losses first {losses[0]}, last "
              f"{losses[-1]}; on {card}", flush=True)
        del unet, mask
        torch.cuda.empty_cache()
    unet = wl.init_unet(SEED)
    start = {n: p.detach().clone() for n, p in unet.named_parameters()}
    compvis = {ours: ck for ck, ours in sd_unet_key_map(unet.cfg)}
    _zero_launches()
    state = TR.nsfw_removal(wl, unet, fb, rb, n_iters=1, lr=1e-5,
                            train_method="xattn", seed=SEED)
    torch.cuda.synchronize()
    launches = _read_all_launches()
    _expect_launches("nsfw_removal (xattn, 1 step)", launches,
                     sd_launches(grad_passes=2, forwards=1))
    params = dict(unet.named_parameters())
    held = {n for n, p in params.items() if state.optimizer.state.get(p)}
    attn2 = {n for n in params if "attn2" in compvis[n]}
    frozen_same = all(torch.equal(params[n].detach(), start[n])
                      for n in params if n not in attn2)
    moved = sum(not torch.equal(params[n].detach(), start[n]) for n in attn2)
    if held != attn2 or not frozen_same or not moved:
        fail(f"nsfw_removal under xattn: Adam state for {len(held)} "
             f"parameters (attn2: {len(attn2)}), the others the same bits: "
             f"{frozen_same}, attn2 moved: {moved}")
    print(f"  nsfw_removal (xattn, 1 step): Adam state for the {len(held)} "
          f"attn2 parameters only, the other {len(params) - len(attn2)} the "
          f"same bits, {moved} attn2 parameters moved", flush=True)
    out["xattn"] = {"launches": launches, "adam_state": len(held),
                    "attn2_moved": moved}
    del unet, start, state, params
    torch.cuda.empty_cache()
    return out


def sd_prox_time(card: str, gen) -> dict:
    """Phase 21 (c): one ``make_prox_operator`` call at full width (top
    ratio SD_TOP_RATIO of 859,520,964 |deltas|, a kthvalue over all of
    them), timed on the host clock around a device wait, with its peak
    memory."""
    import torch

    from uurg_torch.workloads.sd import SDWorkload

    wl = SDWorkload.build(device="cuda")
    init = wl.init_unet(SEED)
    unet = wl.init_unet(SEED)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_(torch.randn(p.shape, generator=gen, device="cuda") * 1e-4)
    prox = wl.make_prox_operator(init, SD_TOP_RATIO)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    thresh = prox(unet)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (float(thresh) > 0 and all(bool(torch.isfinite(p).all())
                                      for p in unet.parameters())):
        fail(f"the prox's threshold {float(thresh)} or weights are wrong")
    print(f"  prox at full width (top {SD_TOP_RATIO:.0%}): {secs * 1e3:.3f} "
          f"ms on the host clock, threshold {float(thresh):.4e}, peak "
          f"{peak:.3f} GiB ({peak - base:.3f} above the two UNets and the "
          f"anchors) on {card}", flush=True)
    del init, unet, prox
    torch.cuda.empty_cache()
    return {"ms": secs * 1e3, "threshold": float(thresh), "peak_gib": peak,
            "transient_gib": peak - base}


def _compvis_file(path: str) -> dict:
    import torch

    return torch.load(path, map_location="cpu",
                      weights_only=True)["state_dict"]


def _check_final(name: str, path: str, start: dict) -> None:
    """A CLI's final weights: the CompVis key set, finite, moved."""
    import torch

    got = _compvis_file(path)
    if set(got) != set(start):
        fail(f"{name}: {path} holds another key set")
    if not all(bool(torch.isfinite(v).all()) for v in got.values()):
        fail(f"{name}: {path} holds non-finite weights")
    if all(torch.equal(got[k], start[k]) for k in start):
        fail(f"{name}: {path} is its start")


@contextlib.contextmanager
def esd_draws():
    """Keep the DDIM index ``t_enc`` of every batch the ESD builder draws."""
    from uurg_torch.workloads import sd_runner as TR

    drawn = []
    draw = TR.ESDBatchBuilder.draw

    def kept(self, generator):
        out = draw(self, generator)
        drawn.append(out[0])
        return out

    TR.ESDBatchBuilder.draw = kept
    try:
        yield drawn
    finally:
        TR.ESDBatchBuilder.draw = draw


def sd_method_clis(work: str, card: str) -> dict:
    """Phase 21 (c): the five SD method CLIs in this process with
    ``--device cuda``, each with the launch counters zeroed just before and
    read just after: ``nsfw_removal`` under phase 20's mask, packed,
    SD_CLI_ITERS steps and a snapshot at the last (``step_<i>.pt`` and the
    Diffusers ``.npz``, whose keys are diffusers' and whose values are the
    CompVis file's through the two key maps), then ``train_esd``,
    ``gradient_ascent``, ``proximal_gradient`` and ``random_label`` from its
    ``final.pt``. Every final.pt holds the CompVis keys, finite, and moved
    from its start. Each folder is one VAE encode of its SD_PNG_EACH
    images."""
    import numpy as np
    import torch

    from uurg_torch.cli import (gradient_ascent, nsfw_removal,
                                proximal_gradient, random_label, train_esd)
    from uurg_torch.io.diffusers_interop import diffusers_key_map
    from uurg_torch.io.sd_interop import (PREFIX, sd_unet_key_map,
                                         torch_unet_to_compvis)
    from uurg_torch.models.sd_unet import SDUNet, SDUNetConfig, init_sd_unet

    nsfw, clothed = (os.path.join(work, d) for d in ("nsfw", "not-nsfw"))
    mask = os.path.join(work, "fisher", f"nude_mask_{SD_THRESHOLD}")
    encodes = {"group_norm_fwd": 2 * -(-SD_PNG_EACH // 8) * VAE_GN_ENCODE,
               "attention_fwd_f32": 2 * -(-SD_PNG_EACH // 8)}
    common = ["--image_size", str(SD_RES), "--batch_size", str(SD_BATCH),
              "--seed", str(SEED)]
    data = ["--forget_data", nsfw, "--remain_data", clothed]
    it = str(SD_CLI_ITERS)
    out, secs, launches = {}, {}, {}

    def run(name, main, argv, want):
        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        main([*argv, "--save_path", os.path.join(work, name)])
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches[name] = _read_all_launches()
        _expect_launches(name, launches[name], want() if callable(want)
                         else want)
        torch.cuda.empty_cache()
        return os.path.join(work, name, "final.pt")

    n = SD_CLI_ITERS
    final = run("nsfw_removal", nsfw_removal.main, [
        *common, "--nsfw_data", nsfw, "--not_nsfw_data", clothed,
        "--mask_path", mask, "--pack_mask", "--n_iters", it,
        "--snapshot_freq", it],
        _plus(sd_launches(grad_passes=2 * n, forwards=n), encodes))
    run_dir = os.path.join(work, "nsfw_removal")
    files = sorted(os.listdir(run_dir))
    want_files = ["final.pt", f"step_{n - 1}.pt",
                  f"step_{n - 1}_diffusers.npz"]
    if files != want_files:
        fail(f"nsfw_removal wrote {files}, not {want_files}")
    t0 = time.perf_counter()
    snap = _compvis_file(os.path.join(run_dir, f"step_{n - 1}.pt"))
    cfg = SDUNetConfig()
    with torch.device("meta"):
        names = set(SDUNet(cfg).state_dict())
    to_compvis = {ours: f"{PREFIX}{ck}" for ck, ours in
                  sd_unet_key_map(cfg)}
    with np.load(os.path.join(run_dir, f"step_{n - 1}_diffusers.npz")) as d:
        keys = {k for k, ours in diffusers_key_map(cfg) if ours in names}
        if set(d.files) != keys:
            fail("the diffusers npz holds another key set")
        for k, ours in diffusers_key_map(cfg):
            if k in keys and not np.array_equal(
                    d[k], snap[to_compvis[ours]].numpy()):
                fail(f"the diffusers npz's {k} is not the snapshot's "
                     f"{to_compvis[ours]}")
    check_s = time.perf_counter() - t0
    sizes = {f: os.path.getsize(os.path.join(run_dir, f)) for f in files}
    for f in files[1:]:                               # 3.44 GB each
        os.remove(os.path.join(run_dir, f))
    start = torch_unet_to_compvis(init_sd_unet(0, cfg, "cuda"), cfg)
    _check_final("nsfw_removal", final, start)
    del snap, start
    print(f"  nsfw_removal CLI ({n} steps, packed mask, snapshot at step "
          f"{n - 1}): {secs['nsfw_removal']:.3f} s; files {sizes}; the npz's "
          f"{len(keys)} diffusers keys equal the CompVis snapshot's "
          f"({check_s:.3f} s to check)", flush=True)
    start = _compvis_file(final)
    with esd_draws() as drawn:
        def esd_want():
            denoise = sum(SD_ESD_DDIM - t + 1 if t > 0 else SD_ESD_DDIM
                          for t in drawn)
            return sd_launches(forwards=denoise + 2 * n, xattn_passes=n)

        esd = run("train_esd", train_esd.main, [
            "--ckpt_path", final, "--iterations", it, "--ddim_steps",
            str(SD_ESD_DDIM), "--image_size", str(SD_RES), "--seed",
            str(SEED)], esd_want)
    got = _compvis_file(esd)
    if not all(torch.equal(got[k], start[k]) for k in start
               if "attn2" not in k):
        fail("train_esd (xattn) moved a parameter outside attn2")
    del got
    _check_final("train_esd", esd, start)
    out["esd_t_enc"] = list(drawn)
    m = SD_BASELINE_ITERS
    for name, main, argv, want in (
            ("gradient_ascent", gradient_ascent.main, [],
             sd_launches(grad_passes=2 * m)),
            ("proximal_gradient", proximal_gradient.main,
             ["--top_ratio", str(SD_TOP_RATIO)],
             sd_launches(grad_passes=2 * m)),
            ("random_label", random_label.main, [],
             sd_launches(grad_passes=2 * m, forwards=m))):
        path = run(name, main, [*common, *data, *argv, "--ckpt_path", final,
                                "--n_iters", str(m)], _plus(want, encodes))
        _check_final(name, path, start)
        os.remove(path)
    os.remove(esd)
    print(f"  the CLIs' seconds {json.dumps(secs)}; ESD's t_enc draws "
          f"{out['esd_t_enc']} (DDIM-{SD_ESD_DDIM}); on {card}", flush=True)
    out.update(seconds=secs, launches=launches, files=sizes)
    return out


def sd_methods_path(card: str, gen, work: str) -> dict:
    """Phase 21: SD's unlearning methods on the card."""
    import torch

    out = {"mask_cli": sd_mask_cli(work)}
    mask = os.path.join(work, "fisher", f"nude_mask_{SD_THRESHOLD}")
    out["sfron"] = sd_sfron_step(card, mask, gen)
    out["prox"] = sd_prox_time(card, gen)
    out["clis"] = sd_method_clis(work, card)
    torch.cuda.empty_cache()
    cli = out["clis"]["launches"]
    out["launches"] = {
        "sd_sfron": _plus(out["sfron"]["dense"]["launches"],
                          out["sfron"]["packed"]["launches"]),
        "sd_sfron_xattn": out["sfron"]["xattn"]["launches"],
        "sd_nsfw_removal": cli["nsfw_removal"], "sd_esd": cli["train_esd"],
        "sd_ga": cli["gradient_ascent"], "sd_prox": cli["proximal_gradient"],
        "sd_rl": cli["random_label"]}
    return out


def sd_kernel_rows(sd: dict, meta: dict) -> list[dict]:
    """The ``kernels`` rows of Stable Diffusion (phase 20): each kernel
    summed over an SD UNet forward (or backward) at SD_BATCH, the sum over
    its sites of the device ms a launch at the site's shape (CUDA-graph
    replay); the GroupNorm backward's split sites again on their own row;
    launches over the main-path runs of phase 20 (sd_generate_fisher and
    the three samplers) and phase 21 (nsfw_removal's counted steps, dense
    and packed, and its xattn step; the five method CLIs)."""
    rows = []
    attn = sd["attention_rows"]
    groups = (
        ("attention_fwd", [r for r in attn if r["name"] == "attention_fwd"],
         "forward"),
        ("attention_bwd", [r for r in attn if r["name"] == "attention_bwd"],
         "backward"),
        ("group_norm_fwd", sd["gn_fwd_rows"], "forward"),
        ("group_norm_bwd", sd["gn_bwd_rows"], "backward"),
        ("group_norm_bwd", [r for r in sd["gn_bwd_rows"]
                            if r["route"] == "split"], "backward, split"))
    for i, (counter, mine, per) in enumerate(groups):
        if not mine:                        # no split site at this batch
            continue

        def total(k, mine=mine):
            return sum(r[k] * r["sites_per_forward"] for r in mine)

        paths = {p: got[counter] for p, got in sd["launches"].items()}
        name = f"{counter}_sd" + ("_split" if i == 4 else "")
        rows.append({
            "name": name, "route": "cuda", "source": meta[counter]["source"],
            "replaces": meta[counter]["replaces"],
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            **{k: total(k) for k in ("ms", "eager_ms", "plain_ms",
                                     "library_ms")},
            "bound_ms": max(total("bytes_ms"), total("ops_ms")),
            "bound_by": ("bytes" if total("bytes_ms") >= total("ops_ms")
                         else "operations"),
            **({"kernels_per_call": sorted({r["kernels_per_call"]
                                            for r in mine}),
                "floor_ms": 5 / 3 * total("bytes_ms")} if i == 4 else {}),
            "per": f"SD UNet {per} at batch {SD_BATCH}, 64 x 64 latents: "
                   f"{sum(r['sites_per_forward'] for r in mine)} calls "
                   f"at {len(mine)} shapes, device ms by CUDA-graph replay; "
                   f"library: " + ("bf16 SDPA" if "attention" in counter
                                   else "F.group_norm")
                   + (" backward" if "bwd" in counter else "")})
    return rows


def sd_eval_generate(work: str, final: str, card: str) -> dict:
    """Phase 22 (a): ``generate_images`` in this process from ``final``
    (a CompVis file an unlearning CLI wrote), the launch counters zeroed
    just before each run and read just after: lms at the CLI's settings on
    the last case, then ddim and plms at SD_SAMPLE_STEPS steps on cases 1-3.
    Exact launches (15 attention and 61 GroupNorm a UNet forward, 30
    GroupNorm and one float32 attention a decode), the PNG files (none for
    case 0), the equal cases byte-equal, no image constant; case 1's ddim
    PNGs bit-equal to ``make_sampler`` + ``decode`` + truncation from its
    seed here; the decode's GroupNorm sites at SD_RES px against the plain
    version; the decode's eager ms at SD_RES px by CUDA events."""
    import numpy as np
    import torch
    from PIL import Image

    from uurg_torch.cli import generate_images, sd_common

    prompts = os.path.join(work, "prompts.csv")
    with open(prompts, "w", newline="") as f:
        f.write(SD_EVAL_PROMPTS)
    n = SD_EVAL_SAMPLES
    built = {}
    setup = sd_common.setup_workload

    def kept(args, device=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = setup(args, device)
        torch.cuda.synchronize()
        built.update(wl=out[0], unet=out[1], setup_s=time.perf_counter() - t0)
        return out

    out = {}
    runs = (("lms", SD_EVAL_LMS_STEPS, 3), ("ddim", SD_SAMPLE_STEPS, 1),
            ("plms", SD_SAMPLE_STEPS, 1))
    sd_common.setup_workload = kept
    try:
        for method, steps, first in runs:
            folder = os.path.join(work, f"gen_{method}")
            argv = ["--prompts_path", prompts, "--save_path", folder,
                    "--ckpt_path", final, "--sampler", method,
                    "--num_samples", str(n), "--from_case", str(first),
                    "--device", "cuda"]
            if method != "lms":             # lms runs at the CLI's defaults
                argv += ["--ddim_steps", str(steps)]
            cases = list(range(first, 4))
            forwards = steps + (method == "plms")
            torch.cuda.synchronize()
            _zero_launches()
            secs, _, _ = run_cli("generate_images", argv)
            launches = _read_all_launches()
            _expect_launches(f"generate_images {method}", launches, {
                **{k: 0 for k in launches},
                "attention_fwd": len(cases) * forwards * SD_ATTN_SITES,
                "group_norm_fwd": len(cases) * (forwards * SD_UNET_GN_SITES
                                                + VAE_GN_DECODE),
                "attention_fwd_f32": len(cases)})
            want = [f"{c}_{i}.png" for c in cases for i in range(n)]
            files = sorted(os.listdir(folder))
            if files != want:
                fail(f"generate_images {method} wrote {files}, not {want}")
            pngs = {}
            for name in files:
                with open(os.path.join(folder, name), "rb") as f:
                    pngs[name] = f.read()
                img = np.asarray(Image.open(os.path.join(folder, name)))
                if img.shape != (SD_RES, SD_RES, 3) or img.std() == 0:
                    fail(f"generate_images {method}: {name} is "
                         f"{img.shape} or constant")
            if 2 in cases and any(pngs[f"2_{i}.png"] != pngs[f"3_{i}.png"]
                                  for i in range(n)):
                fail(f"generate_images {method}: cases 2 and 3 (one prompt, "
                     f"one seed) differ")
            sampling = secs - built["setup_s"]
            out[method] = {
                "seconds": secs, "setup_s": built["setup_s"],
                "sampling_s": sampling, "images": len(files),
                "images_per_s": len(files) / sampling, "launches": launches,
                "unet_forwards": len(cases) * forwards}
            print(f"  generate_images {method} ({steps} steps, CFG "
                  f"{SD_GUIDANCE}, cases {cases} x {n} at {SD_RES} px): "
                  f"{secs:.3f} s, of which the workload and {final} "
                  f"{built['setup_s']:.3f} s; {len(files) / sampling:.4f} "
                  f"images/s sampling and decoding on {card}", flush=True)
            if method == "ddim":
                out["same_as_sampler"] = sd_eval_same_bits(
                    built["wl"], built["unet"], folder, card)
                out["decode_gn_sites"] = sd_decode_gn_sites(built["wl"].vae)
            built.clear()
    finally:
        sd_common.setup_workload = setup
    torch.cuda.empty_cache()
    return out


def sd_eval_same_bits(wl, unet, folder: str, card: str) -> dict:
    """Case 1's PNGs from ``generate_images`` ddim against this phase's own
    ``make_sampler`` + ``decode`` + the CLI's truncation from the case's
    seed (bit for bit), the decode finite; then the decode of
    SD_EVAL_SAMPLES latents at SD_RES px timed eagerly with CUDA events
    (host launch gaps included)."""
    import numpy as np
    import torch
    from PIL import Image

    from uurg_torch.cli.generate_images import read_prompts, to_uint8

    path = os.path.join(os.path.dirname(folder), "prompts.csv")
    case, prompt, seed = read_prompts(path, 1)[0]
    ctx = wl.get_learned_conditioning([prompt]).repeat(SD_EVAL_SAMPLES, 1, 1)
    sample = wl.make_sampler(num_steps=SD_SAMPLE_STEPS,
                             guidance_scale=SD_GUIDANCE,
                             latent_size=SD_LATENT, method="ddim")
    z = sample(unet, ctx, generator=torch.Generator(
        device="cuda").manual_seed(seed))
    with torch.inference_mode():
        imgs = wl.vae.decode(z)
        if not torch.isfinite(imgs).all():
            fail("generate_images: a decoded image is not finite")
        want = to_uint8(imgs.cpu().numpy())
        for i in range(SD_EVAL_SAMPLES):
            got = np.asarray(Image.open(os.path.join(folder,
                                                     f"{case}_{i}.png")))
            if not np.array_equal(got, want[i]):
                fail(f"generate_images: {case}_{i}.png differs from "
                     f"make_sampler + decode from seed {seed}")
        wl.vae.decode(z)                                    # warm
        decode_ms = _events_ms(lambda: [wl.vae.decode(z) for _ in range(3)],
                               3)
    print(f"  case {case}'s {SD_EVAL_SAMPLES} PNGs bit-equal to "
          f"make_sampler + decode + truncation from seed {seed}; decode of "
          f"{SD_EVAL_SAMPLES} latents at {SD_RES} px {decode_ms:.3f} ms "
          f"eager (CUDA events) on "
          f"{card}", flush=True)
    return {"case": case, "seed": seed, "decode_ms": decode_ms,
            "decode_batch": SD_EVAL_SAMPLES}


def sd_decode_gn_sites(vae) -> list[dict]:
    """Phase 22 (a): the GroupNorm forward at every fp32 site shape of the
    VAE's decode at SD_RES px (found by one batch-1 pass), at the decode
    batches of phases 22 and 20 (SD_EVAL_SAMPLES and SD_PROMPTS: the split
    route's 264 and 132 runs a sample, where phase 19 (b) checks 17): y,
    mean and rstd against the plain version, three runs with equal bits.
    Off the counted runs. Returns one row a site shape and batch."""
    import torch

    from uurg_torch.ops import group_norm as GN

    count = {k: dec for k, (_, dec) in vae_gn_site_counts(vae, SD_RES).items()
             if dec}
    if sum(count.values()) != VAE_GN_DECODE:
        fail(f"the VAE's decode at {SD_RES} px has {sum(count.values())} "
             f"GroupNorm sites, not {VAE_GN_DECODE}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for B in (SD_EVAL_SAMPLES, SD_PROMPTS):
        for (H, W, C), dec in sorted(count.items()):
            x = torch.randn(B, H, W, C, generator=gen, device="cuda") * 2 + 0.5
            scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
            bias = torch.randn(C, generator=gen, device="cuda") * 0.2
            route = GN._fwd_route(H * W, C, 4, 32, B)
            tag = (f"group_norm B={B} H={H} W={W} C={C} fp32 ({route[0]}, "
                   f"{route[1]} blocks a sample)")
            got = GN._group_norm_kernel(x, scale, bias, 32, 1e-6)
            torch.cuda.synchronize()
            want = GN.group_norm_plain(x, scale, bias, 32, 1e-6, True)
            err = compare(tag, got[0], want[0], GN_FP32_ATOL, GN_FP32_RTOL)
            compare(f"{tag} mean", got[1], want[1], GN_FP32_ATOL,
                    GN_FP32_RTOL)
            compare(f"{tag} rstd", got[2], want[2], GN_RSTD_TOL, GN_RSTD_TOL)
            del want
            for _ in range(RAGGED_REPEATS - 1):
                again = GN._group_norm_kernel(x, scale, bias, 32, 1e-6)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"{tag}: repeated runs differ in their bits")
                del again
            rows.append({"shape": {"B": B, "H": H, "W": W, "C": C, "G": 32},
                         "route": route[0], "blocks_a_sample": route[1],
                         "sites_decode": dec, "max_abs_err": err})
            del got, x
    torch.cuda.empty_cache()
    print(f"  the decode's {VAE_GN_DECODE} GroupNorm sites at {SD_RES} px "
          f"({len(count)} shapes) at batches {SD_EVAL_SAMPLES} and "
          f"{SD_PROMPTS} ({sorted({r['route'] for r in rows})}, "
          f"{sorted({r['blocks_a_sample'] for r in rows})} blocks a sample): "
          f"kernel vs plain within {GN_FP32_ATOL}, largest error "
          f"{max(r['max_abs_err'] for r in rows):.3e}, three runs equal",
          flush=True)
    return rows


def sd_eval_classify(work: str, folder: str, card: str) -> dict:
    """Phase 22 (b): ``imageclassify`` on ``folder`` with a seeded ResNet50
    (CIFAR stem, 10 classes) whose BatchNorm statistics and head bias are
    perturbed, saved as a ``.pth``; its CSV rows must be the top 5 of the
    argsort of this phase's own logits on the card. No kernel launches."""
    import csv

    import numpy as np
    import torch
    from PIL import Image

    from uurg_torch.eval.classifier_eval import resize_batch
    from uurg_torch.models import create_model, init_classifier

    g = torch.Generator().manual_seed(SEED)
    model = init_classifier(g, create_model("ResNet50", 10))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.1, generator=g)
                mod.running_var.uniform_(0.5, 2.0, generator=g)
                mod.weight.uniform_(0.5, 1.5, generator=g)
        model.fc.bias.normal_(0.0, 0.1, generator=g)
    pth = os.path.join(work, "resnet50.pth")
    torch.save(model.state_dict(), pth)
    csv_path = os.path.join(work, "topk.csv")
    _zero_launches()
    secs, _, _ = run_cli("imageclassify", [
        "--folder_path", folder, "--save_path", csv_path,
        "--classifier_ckpt", pth, "--device", "cuda"])
    launches = _read_all_launches()
    _expect_launches("imageclassify", launches, {k: 0 for k in launches})
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    names = sorted(os.listdir(folder))
    imgs = np.stack([np.asarray(Image.open(os.path.join(folder, n))
                                .convert("RGB")) for n in names])
    model = model.to("cuda").eval()
    with torch.inference_mode():
        model(resize_batch(imgs, 224, "cuda"))              # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z = model(resize_batch(imgs, 224, "cuda")).float().cpu().numpy()
        fwd = time.perf_counter() - t0
    want = [["image"] + [f"top{i + 1}" for i in range(5)]] + [
        [n] + [str(int(c)) for c in np.argsort(-zi)[:5]]
        for n, zi in zip(names, z)]
    if rows != want:
        fail(f"imageclassify wrote {rows}, not the argsort of the logits "
             f"{want}")
    print(f"  imageclassify (ResNet50, CIFAR stem, 224 px) on {len(names)} "
          f"images: {secs:.3f} s in all; the forward {len(names) / fwd:.1f} "
          f"images/s on {card}; rows = argsort of the card's logits",
          flush=True)
    return {"seconds": secs, "images": len(names),
            "forward_images_per_s": len(names) / fwd, "launches": launches,
            "rows": rows[1:]}


def sd_eval_nudenet(work: str, folder: str) -> dict:
    """Phase 22 (c): ``nudenet_classes`` with an ``.npz`` of recorded heads
    (1, 4 + 18, NUDENET_ANCHORS) for each PNG of ``folder`` (SD_RES px: the
    letterbox scale 320 / 512 = 0.625, no pad). Each image gets a box of
    one class at score 0.9 and its near-duplicate at 0.85 (NMS drops it),
    a second class at 0.5 (kept by the decoder, under the CLI's
    threshold), one at 0.1 (under the decoder's); every third image a
    third class at 0.7. The CSV must hold exactly the classes above
    NUDENET_THRESHOLD, and a box must map back to its pixels."""
    import csv

    import numpy as np

    from uurg_torch.eval.nudenet import NUDENET_LABELS, make_npz_detector

    names = sorted(os.listdir(folder))
    C = len(NUDENET_LABELS)
    s = NUDENET_SIZE / SD_RES
    heads, want, boxes = {}, {}, {}
    for k, name in enumerate(names):
        raw = np.zeros((1, 4 + C, NUDENET_ANCHORS), np.float32)
        x1, y1 = 40 + 24 * k, 64 + 8 * k
        box = (x1, y1, x1 + 160, y1 + 96)
        plant = [(box, k % C, 0.9), ((300, 300, 380, 360), (k + 5) % C, 0.5),
                 ((10, 400, 50, 440), (k + 9) % C, 0.1)]
        if k % 3 == 0:
            plant.append(((200, 20, 260, 120), (k + 13) % C, 0.7))
        dup = ((x1 + 4, y1 + 4, x1 + 164, y1 + 100), k % C, 0.85)
        for a, ((bx1, by1, bx2, by2), c, score) in enumerate(plant + [dup]):
            raw[0, :4, 97 * a + 5 * k] = ((bx1 + bx2) / 2 * s,
                                          (by1 + by2) / 2 * s,
                                          (bx2 - bx1) * s, (by2 - by1) * s)
            raw[0, 4 + c, 97 * a + 5 * k] = score
        heads[name] = raw
        above = sorted(((score, NUDENET_LABELS[c]) for (_, c, score) in plant
                        if score >= NUDENET_THRESHOLD), reverse=True)
        want[name] = ";".join(label for _, label in above)
        boxes[name] = box
    npz = os.path.join(work, "recorded_heads.npz")
    np.savez(npz, **heads)
    csv_path = os.path.join(work, "nudenet.csv")
    secs, _, _ = run_cli("nudenet_classes", [
        "--folder", folder, "--save_path", csv_path, "--model_path", npz,
        "--threshold", str(NUDENET_THRESHOLD)])
    with open(csv_path, newline="") as f:
        got = {r["image"]: r["classes"] for r in csv.DictReader(f)}
    if got != want:
        fail(f"nudenet_classes wrote {got}, not {want}")
    dets = make_npz_detector(npz)(os.path.join(folder, names[0]))
    if not np.allclose(dets[0]["box"], boxes[names[0]], atol=1e-3):
        fail(f"nudenet: the box {dets[0]['box']} does not map back to "
             f"{boxes[names[0]]}")
    print(f"  nudenet_classes ({len(names)} images, recorded heads "
          f"(1, {4 + C}, {NUDENET_ANCHORS}), threshold {NUDENET_THRESHOLD}): "
          f"{secs:.3f} s; the CSV holds exactly the planted classes above "
          f"it; boxes map back to the {SD_RES} px pixels", flush=True)
    return {"seconds": secs, "images": len(names), "classes": got}


def sd_eval_fid(work: str, folder: str, card: str) -> dict:
    """Phase 22 (d): ``compute_fid`` between phase 20's two PNG folders
    (two classes; ``--class_to_forget`` drops ``nsfw``) and ``folder`` at
    SD_RES px, the seeded InceptionV3 on the card: the FID finite and
    non-negative; the feature seconds (card, with the PNG decoding) and the
    Fréchet seconds (host) read from its log. No kernel launches."""
    import math

    real = os.path.join(work, "real")
    os.makedirs(real)
    for name in ("nsfw", "not-nsfw"):
        os.symlink(os.path.join(work, name, "c0"), os.path.join(real, name))
    drop = sorted(os.listdir(real)).index("nsfw")
    _zero_launches()
    secs, stdout, log = run_cli("compute_fid", [
        "--folder_path", folder, "--real_path", real, "--class_to_forget",
        str(drop), "--image_size", str(SD_RES), "--device", "cuda"])
    launches = _read_all_launches()
    _expect_launches("compute_fid", launches, {k: 0 for k in launches})
    fid = float(stdout.split("FID:")[1])
    m = re.search(r"features of (\d+) real \+ (\d+) generated images: "
                  r"([\d.]+) s; Fréchet distance on the host: ([\d.]+) s",
                  log)
    if not m or not math.isfinite(fid) or fid < 0:
        fail(f"compute_fid printed FID {fid}; log {log[-500:]}")
    n_real, n_fake = int(m.group(1)), int(m.group(2))
    if n_real != SD_PNG_EACH or n_fake != len(os.listdir(folder)):
        fail(f"compute_fid read {n_real} + {n_fake} images")
    print(f"  compute_fid ({n_real} real + {n_fake} generated at {SD_RES} "
          f"px): FID {fid:.4f}; features {float(m.group(3)):.3f} s on "
          f"{card}, Fréchet {float(m.group(4)):.3f} s on the host; "
          f"{secs:.3f} s in all", flush=True)
    return {"seconds": secs, "fid": fid, "real": n_real, "generated": n_fake,
            "features_s": float(m.group(3)), "frechet_s": float(m.group(4)),
            "launches": launches}


def sd_eval_path(card: str, work: str) -> dict:
    """Phase 22: SD's evaluation on the card, from phase 21's
    ``nsfw_removal`` ``final.pt`` and phase 20's PNG folders under
    ``work``."""
    t0 = time.perf_counter()
    final = os.path.join(work, "nsfw_removal", "final.pt")
    ev = os.path.join(work, "eval")
    os.makedirs(ev)
    out = {"generate": sd_eval_generate(ev, final, card)}
    folder = os.path.join(ev, "gen_ddim")
    out["imageclassify"] = sd_eval_classify(ev, folder, card)
    out["nudenet"] = sd_eval_nudenet(ev, folder)
    out["fid"] = sd_eval_fid(work, folder, card)
    gen = out["generate"]
    out["launches"] = {f"sd_gen_{m}": gen[m]["launches"]
                       for m in ("lms", "ddim", "plms")}
    out["seconds"] = time.perf_counter() - t0
    return out


def _host_params(model) -> dict:
    """Every parameter of ``model`` whole (the sharded ones gathered, in
    the one-device layout), on the host, with the number of sharded ones
    under ``None``."""
    from uurg_torch.parallel.mesh import full_tensor, is_sharded

    out = {n: full_tensor(p.detach(), p).cpu()
           for n, p in model.named_parameters()}
    out[None] = sum(is_sharded(p) for p in model.parameters())
    return out


def _tp_pieces(model) -> dict:
    """``{name: recorded pieces}`` of the tensor-parallel parameters."""
    from uurg_torch.parallel.mesh import tp_pieces

    return {n: tp_pieces(p) for n, p in model.named_parameters()
            if tp_pieces(p)}


def _param_diff(got: dict, want: dict) -> tuple[float, float]:
    """(largest |difference|, relative L2) over every parameter of two
    ``_host_params`` records, a parameter at a time on the card."""
    import torch

    big = num = den = 0.0
    if list(got) != list(want):
        fail("the parameters' names or order differ")
    for n, q in want.items():
        if n is None:
            continue
        q = q.to("cuda", torch.float64)
        d = got[n].to("cuda", torch.float64) - q
        big = max(big, d.abs().max().item())
        num += d.square().sum().item()
        den += q.square().sum().item()
    return big, (num / den) ** 0.5


def _dp_call(run, runner, keep, profile_step: int | None = None):
    """``run()`` with the launch counters zeroed just before and read just
    after: (``keep`` of its result, launches, ms between CUDA events around
    it, peak GiB, the host ms from the call's start to the end of each
    SFR-on step that ``runner`` builds, after a device wait, and
    ``dit_clock``'s record: step ``profile_step`` profiled, its device ms
    by kernel family). The result itself is dropped and the cache emptied
    before the next run, so that no run's peak holds another's state."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with dit_clock(runner, profile_step=profile_step,
                   families=profile_step is not None) as rec:
        _zero_launches()
        t0 = time.perf_counter()
        start.record()
        out = run()
        end.record()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res = (keep(out), _read_all_launches(), start.elapsed_time(end), peak,
           [(t - t0) * 1e3 for t in rec["t"]], rec)
    del out
    _collect()
    return res


def _collect() -> None:
    """Free what no one refers to, cycles included, and return the
    cache's blocks to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _dp_profiled(tag: str, one: tuple, group: tuple) -> dict:
    """The profiled step of both runs: device busy ms and wall ms, and the
    kernel families whose device ms differ."""
    a, b = one[5], group[5]
    print(f"  {tag}, the profiled step: device {b['busy_ms']:.3f} ms (one "
          f"device {a['busy_ms']:.3f}), wall {b['profiled_ms']:.3f} ms (one "
          f"device {a['profiled_ms']:.3f})", flush=True)
    fams = sorted(set(a["by_family"]) | set(b["by_family"]))
    delta = {f: b["by_family"].get(f, 0.0) - a["by_family"].get(f, 0.0)
             for f in fams}
    for f in sorted(fams, key=lambda f: -abs(delta[f])):
        if abs(delta[f]) >= 0.05:
            print(f"    {f:22s} {b['by_family'].get(f, 0.0):10.3f} ms (one "
                  f"device {a['by_family'].get(f, 0.0):.3f})", flush=True)
    return {"busy_ms": b["busy_ms"], "one_device_busy_ms": a["busy_ms"],
            "wall_ms": b["profiled_ms"],
            "one_device_wall_ms": a["profiled_ms"],
            "by_family": b["by_family"],
            "one_device_by_family": a["by_family"]}


def dp_draw_cost(config, card: str) -> dict:
    """Phase 23 (d): what drawing the global batch's randomness costs a
    rank: the CondUNet's training loss (t, noise, keep mask and its
    dropout masks drawn, forward and backward) at TRAIN_BATCH rows, drawn
    for those rows alone and for DP_DRAW_RANKS times as many, as rank 0 of
    a data axis of DP_DRAW_RANKS ranks draws them (the split stood in for:
    one card holds one rank); CUDA events over 5 calls after a warm-up,
    and each call's peak memory."""
    import torch

    from uurg_torch.core import rng as RNG
    from uurg_torch.parallel.mesh import BatchSplit
    from uurg_torch.workloads.ddpm import DDPMWorkload

    wl = DDPMWorkload.from_config(config)
    model = wl.init_params(SEED)
    loss = wl.train_loss_fn()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(TRAIN_BATCH, 32, 32, 3, generator=g, device="cuda")
    c = torch.randint(0, config.data.n_classes, (TRAIN_BATCH,), generator=g,
                      device="cuda")

    def call():
        model.zero_grad(set_to_none=True)
        loss(model, (x, c), g).backward()

    out, split = {}, RNG.batch_split
    try:
        for count in (1, DP_DRAW_RANKS):
            RNG.batch_split = lambda: BatchSplit(0, count)
            call()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = _events_ms(lambda: [call() for _ in range(5)], 5)
            out[count] = (ms, torch.cuda.max_memory_allocated() / 2 ** 30)
    finally:
        RNG.batch_split = split
    (ms1, gib1), (msn, gibn) = out[1], out[DP_DRAW_RANKS]
    print(f"  global draws at data={DP_DRAW_RANKS}, {TRAIN_BATCH} rows a "
          f"rank (dropout {config.model.dropout}): the loss's forward and "
          f"backward {msn:.3f} ms, peak {gibn:.3f} GiB (its own rows' draws "
          f"{ms1:.3f} ms, peak {gib1:.3f} GiB); on {card}", flush=True)
    return {"ranks": DP_DRAW_RANKS, "ms": msn, "own_rows_ms": ms1,
            "peak_gib": gibn, "own_rows_peak_gib": gib1}


def _dp_compare(tag: str, card: str, one: tuple, group: tuple) -> dict:
    """Hold the run under the group to the one-device run (each kept as
    ``{"model": _host_params, ...}``): the parameters within DP_REL
    relative L2, the launches equal."""
    big, rel = _param_diff(group[0]["model"], one[0]["model"])
    print(f"  {tag}: largest parameter difference {big:.3e}, relative L2 "
          f"{rel:.3e} (gate {DP_REL}); launches {group[1]} (one device "
          f"{one[1]}); {group[2]:.3f} ms (one device {one[2]:.3f}), each "
          f"step's end at {[round(t, 1) for t in group[4]]} ms (one device "
          f"{[round(t, 1) for t in one[4]]}), peak {group[3]:.3f} GiB (one "
          f"device {one[3]:.3f}); on {card}", flush=True)
    if not rel <= DP_REL:
        fail(f"{tag}: the run under the group is {rel:.3e} from the "
             f"one-device run")
    if group[1] != one[1] or not group[1]["attention_fwd"]:
        fail(f"{tag}: launches {group[1]} under the group, {one[1]} on one "
             f"device")
    return {"max_abs": big, "rel_l2": rel, "launches": group[1],
            "ms": group[2], "one_device_ms": one[2], "peak_gib": group[3],
            "one_device_peak_gib": one[3], "step_ends_ms": group[4],
            "one_device_step_ends_ms": one[4]}


def dp_ddpm(config, card: str, group) -> dict:
    """Phase 23 (a): ``sfron_forget`` (phase 8's settings, DP_DDPM_STEPS
    steps) and one DDIM batch of ``sample_images``, first on one device,
    then under the group (``group()`` starts it; the DDPM runner then
    splits every batch over its ranks with no flag)."""
    import numpy as np
    import torch

    from uurg_torch.core.tree import pack_mask
    from uurg_torch.workloads import ddpm_runner as R
    from uurg_torch.workloads.ddpm import DDPMWorkload

    class Args:
        seed = SEED
        ckpt_folder = None
        label_to_forget = 0
        forget_alpha = FORGET_ALPHA
        method = "ron"
        unlearn_loss = "adaga"

    cfg = config.merged({"training": {"n_iters": DP_DDPM_STEPS,
                                      "snapshot_freq": 10 ** 6,
                                      "log_freq": 10 ** 6}})
    wl = DDPMWorkload.from_config(config)
    seeded = R.load_params(Args, config, wl)
    gen = torch.Generator().manual_seed(SEED)
    mask = pack_mask({k: torch.rand(p.shape, generator=gen) < 0.5
                      for k, p in seeded.named_parameters()})
    labels = np.arange(SAMPLING_BATCH) % config.data.n_classes
    runs = {}
    for name in ("one", "group"):
        if name == "group":
            group()
        work = tempfile.mkdtemp(prefix=f"uurg_dp_{name}_")
        try:
            train = _dp_call(lambda: R.sfron_forget(Args, cfg, work,
                                                    mask=mask), R,
                             lambda st: {"model": _host_params(st.model)})
            sample = _dp_call(lambda: R.sample_images(
                Args, config, seeded, labels, num_steps=DDIM_STEPS,
                cond_scale=COND_SCALE, seed=SEED), R, lambda x: x)
        finally:
            for f in os.listdir(work):
                os.remove(os.path.join(work, f))
            os.rmdir(work)
        runs[name] = (train, sample)
    (one_t, one_s), (grp_t, grp_s) = runs["one"], runs["group"]
    out = {"training": _dp_compare(
        f"sfron_forget ({DP_DDPM_STEPS} steps at {TRAIN_BATCH} + "
        f"{TRAIN_BATCH})", card, one_t, grp_t)}
    same = np.array_equal(grp_s[0], one_s[0])
    print(f"  sample_images (one DDIM-{DDIM_STEPS} batch of "
          f"{SAMPLING_BATCH}): uint8 arrays equal {same}; launches "
          f"{grp_s[1]} (one device {one_s[1]}); {grp_s[2]:.3f} ms (one "
          f"device {one_s[2]:.3f})", flush=True)
    if not same or grp_s[1] != one_s[1]:
        fail("sample_images under the group differs from one device")
    out["sampling"] = {"launches": grp_s[1], "ms": grp_s[2],
                       "one_device_ms": one_s[2]}
    return out


def dp_dit(card: str, mesh) -> dict:
    """Phase 23 (b): ``dit_forget`` on phase 18's seeded, perturbed
    DiT-XL/2 (adaga, AdamW 1e-4, EMA, a dense mask of density 0.5),
    DP_DIT_STEPS steps at DIT_BATCH + DIT_BATCH, on one device and under
    FSDP on ``mesh``."""
    import numpy as np
    import torch

    from uurg_torch.workloads import dit_runner as DR
    from uurg_torch.workloads.dit import DiTWorkload

    wl = DiTWorkload.build(DIT_NAME)
    rng = np.random.default_rng(SEED)

    def batch(low, high):       # seeded latents, labels in [low, high)
        return (torch.from_numpy(rng.standard_normal(
            (DIT_BATCH, 32, 32, 4)).astype(np.float32)),
            torch.from_numpy(rng.integers(low, high, DIT_BATCH)))

    # the forget class 0, the remain batches the stand-in's other classes
    fbs = [batch(0, 1) for _ in range(DP_DIT_STEPS)]
    rbs = [batch(1, DIT_STANDIN_CLASSES) for _ in range(DP_DIT_STEPS)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mask = {n: torch.rand(p.shape, generator=gen, device="cuda") < 0.5
            for n, p in wl.init_params(SEED).named_parameters()}
    kw = dict(n_iters=DP_DIT_STEPS, lr=1e-4, forget_alpha=1e-3,
              unlearn_loss="adaga", mask=mask, seed=SEED, log_freq=10 ** 6)

    def keep(st):
        return {"model": _host_params(st.model),
                "ema": _host_params(st.ema_model),
                "pieces": _tp_pieces(st.model)}

    def call(place: dict, profile: bool = True):
        """The run on a fresh seeded model placed by ``place``, its last
        step profiled with ``profile`` (phase 23's runs; a profiled DiT step
        held 2-3 s of wall time); the model collected before the next run
        (FSDP2's state holds it in a reference cycle)."""
        model = perturb_dit_(wl.init_params(SEED))
        res = _dp_call(lambda: DR.dit_forget(
            wl, model, iter(fbs), iter(rbs), **place, **kw), DR, keep,
            DP_DIT_STEPS - 1 if profile else None)
        del model
        _collect()
        return res

    one = call({})
    grp = call({"mesh": mesh, "parallelism": "fsdp"})
    sharded = grp[0]["model"][None]
    print(f"  FSDP2: {sharded} of {len(mask)} parameters sharded (the rest "
          f"under 2**14 elements)", flush=True)
    if not sharded:
        fail("dit_forget under fsdp sharded no parameter")
    out = _dp_compare(f"dit_forget fsdp ({DP_DIT_STEPS} steps at "
                      f"{DIT_BATCH} + {DIT_BATCH})", card, one, grp)
    ema = _param_diff(grp[0]["ema"], one[0]["ema"])
    print(f"  EMA: largest difference {ema[0]:.3e}, relative L2 "
          f"{ema[1]:.3e}", flush=True)
    if not ema[1] <= DP_REL:
        fail("dit_forget's EMA under fsdp differs from one device")
    out["ema_rel_l2"], out["sharded_params"] = ema[1], sharded
    out["profiled_step"] = _dp_profiled("dit_forget fsdp", one, grp)
    return out, one, call


def dp_sd(card: str, mesh, gen) -> dict:
    """Phase 23 (c): ``nsfw_removal`` on phase 20's seeded UNet (train
    method full, Adam, a packed mask of density 0.5), DP_SD_STEPS steps at
    SD_BATCH + SD_BATCH, on one device and under FSDP on ``mesh``."""
    import torch

    from uurg_torch.core.tree import pack_mask
    from uurg_torch.workloads import sd_runner as TR
    from uurg_torch.workloads.sd import SDWorkload

    wl = SDWorkload.build(device="cuda")
    fb, rb = _sd_batches(gen)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    mask = pack_mask({n: torch.rand(p.shape, generator=g, device="cuda")
                      < 0.5 for n, p in wl.init_unet(SEED).named_parameters()})
    kw = dict(n_iters=DP_SD_STEPS, lr=1e-5, saliency_mask=mask, seed=SEED,
              snapshot_freq=10 ** 6)

    def call(place: dict):
        """The run on a fresh seeded UNet placed by ``place``, collected
        before the next run; unprofiled (a profiled SD step held ~13 s of
        wall time a run; phase 21 profiles SD's step)."""
        unet = wl.init_unet(SEED)
        res = _dp_call(
            lambda: TR.nsfw_removal(wl, unet, fb, rb, **place, **kw), TR,
            lambda st: {"model": _host_params(st.model),
                        "pieces": _tp_pieces(st.model)})
        del unet
        _collect()
        return res

    one = call({})
    grp = call({"mesh": mesh, "parallelism": "fsdp"})
    sharded = grp[0]["model"][None]
    print(f"  FSDP2: {sharded} of {len(mask)} parameters sharded, in the "
          f"UNet's own units; the packed mask whole", flush=True)
    if not sharded:
        fail("nsfw_removal under fsdp sharded no parameter")
    out = _dp_compare(f"nsfw_removal fsdp ({DP_SD_STEPS} steps at "
                      f"{SD_BATCH} + {SD_BATCH})", card, one, grp)
    out["sharded_params"] = sharded
    return out, one, call


def _tp_placed(tag: str, pieces: dict, want: dict) -> None:
    """Fail unless every parameter of ``want`` was placed by the rules
    with its pieces recorded, and no other (a one-rank mesh must not skip
    the path)."""
    print(f"  {tag}: {len(pieces)} parameters placed by the rules, "
          f"{sum(k == 3 for k in pieces.values())} with 3 pieces (qkv), "
          f"{sum(k == 6 for k in pieces.values())} with 6 (adaLN), "
          f"{sum(k == 2 for k in pieces.values())} with 2 (GEGLU)",
          flush=True)
    if pieces != want:
        fail(f"{tag}: tensor-parallel placement {sorted(pieces.items())[:6]}"
             f"... is not the rules' {sorted(want.items())[:6]}...")


def tp_dit(card: str, mesh, one: tuple, call) -> dict:
    """Phase 24 (a): ``dit_forget`` under ``parallelism="tp"`` on
    ``mesh`` (DIT_TP_RULES over a one-rank ``model`` axis), against phase
    23's one-device run of the same weights, batches and mask."""
    grp = call({"mesh": mesh, "parallelism": "tp"}, profile=False)
    want = {f"blocks.{i}.{name}": k for i in range(DIT_BLOCKS)
            for name, k in (("attn.qkv.weight", 3), ("attn.qkv.bias", 3),
                            ("adaLN_modulation.1.weight", 6),
                            ("adaLN_modulation.1.bias", 6),
                            ("mlp.fc1.weight", 1), ("mlp.fc1.bias", 1),
                            ("attn.proj.weight", 1), ("mlp.fc2.weight", 1))}
    _tp_placed("dit_forget tp", grp[0]["pieces"], want)
    out = _dp_compare(f"dit_forget tp ({DP_DIT_STEPS} steps at {DIT_BATCH} "
                      f"+ {DIT_BATCH})", card, one, grp)
    ema = _param_diff(grp[0]["ema"], one[0]["ema"])
    print(f"  EMA: largest difference {ema[0]:.3e}, relative L2 "
          f"{ema[1]:.3e}", flush=True)
    if not ema[1] <= DP_REL:
        fail("dit_forget's EMA under tp differs from one device")
    out["ema_rel_l2"], out["tp_params"] = ema[1], len(want)
    return out


def tp_sd(card: str, mesh, one: tuple, call) -> dict:
    """Phase 24 (b): ``nsfw_removal`` under ``parallelism="tp"`` on
    ``mesh`` (SD_TP_RULES over a one-rank ``model`` axis, FSDP over it
    for the rest), against phase 23's one-device run."""
    grp = call({"mesh": mesh, "parallelism": "tp"})
    blocks = sorted({n.rsplit(".", 3)[0] for n in one[0]["model"]
                     if n and n.endswith("ff_geglu.proj.weight")})
    want = {f"{b}.{name}": k for b in blocks for name, k in (
        *((f"attn{a}.to_{w}.weight", 1) for a in (1, 2) for w in "qkv"),
        ("attn1.to_out.weight", 1), ("attn2.to_out.weight", 1),
        ("ff_geglu.proj.weight", 2), ("ff_geglu.proj.bias", 2),
        ("ff_out.weight", 1))}
    _tp_placed("nsfw_removal tp", grp[0]["pieces"], want)
    out = _dp_compare(f"nsfw_removal tp ({DP_SD_STEPS} steps at {SD_BATCH} "
                      f"+ {SD_BATCH})", card, one, grp)
    out["tp_params"], out["sharded_params"] = len(want), grp[0]["model"][None]
    return out


def _views(shape, gen, token_major_qkv: bool, dtype=None):
    """(q, k, v, g) in the layout the model hands the dispatcher: DiT's
    MHSA (views of one fused (B, T, 3, H, D) projection, a token-major
    gradient; bf16 unless ``dtype`` says otherwise) or SD's
    CrossAttention (views of (B, T, H D) bf16 tensors)."""
    import torch

    B, H, T, D = shape
    if token_major_qkv:
        return mhsa_views(B, H, T, D, gen, dtype)
    return tuple(torch.randn(B, T, H * D, generator=gen, device="cuda",
                             dtype=torch.bfloat16)
                 .reshape(B, T, H, D).transpose(1, 2) for _ in range(4))


def ring_loopback(card: str, gen) -> list[dict]:
    """Phase 25 (a): ring attention's arithmetic over S ranks in this
    process (``ring_attention_loopback``) at DiT-XL/2's and SD's bf16
    attention shapes and DiT's float32 one, S in RING_SEQS: the forward
    against ``attention_plain`` and the gradients against its autograd, at
    phases 18's and 20's gates; the launches of one forward and backward
    exactly S and S; the ring's forward and backward timed by CUDA-graph
    replay beside one whole kernel call on the same tensors and its
    bound."""
    import torch

    from uurg_torch.ops import flash_attention as FA
    from uurg_torch.parallel import sequence as SQ

    rows = []
    for tag, shape, mhsa, dtype in (
            ("DiT", DIT_ATTN_SHAPE, True, torch.bfloat16),
            ("SD", RING_SD_SHAPE, False, torch.bfloat16),
            ("DiT f32", DIT_F32_SHAPE, True, torch.float32)):
        f32 = dtype == torch.float32
        suffix = "_f32" if f32 else ""
        q, k, v, g = _views(shape, gen, mhsa, dtype)
        B, H, T, D = shape
        plain = [t.detach().requires_grad_() for t in (q, k, v)]
        want = FA.attention_plain(*plain)
        want_grads = torch.autograd.grad(want, plain, g)
        want = want.detach()
        whole_o, whole_lse = FA._attention_kernel(q, k, v, with_lse=True)
        whole = (time_ms(lambda: FA._attention_kernel(q, k, v,
                                                      with_lse=True))[0],
                 time_ms(lambda: FA.attention_bwd(q, k, v, whole_o,
                                                  whole_lse, g))[0])
        n = B * H * T * D
        peak = FP32_FLOPS if f32 else BF16_TC_FLOPS
        bound = {kind: max(nb * q.element_size() / HBM_BYTES_PER_S,
                           ops / peak) * 1e3
                 for kind, nb, ops in (("fwd", 4 * n, 4 * n * T),
                                       ("bwd", 7 * n, 10 * n * T))}
        for S in RING_SEQS:
            name = f"ring {tag} {shape} over {S} ranks"
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            torch.cuda.synchronize()
            _zero_launches()
            out = SQ.ring_attention_loopback(*leaves, S)
            grads = torch.autograd.grad(out, leaves, g)
            torch.cuda.synchronize()
            launches = _read_all_launches()
            want_n = {f"attention_fwd{suffix}": S,
                      f"attention_bwd{suffix}": S}
            got_n = {kk: launches[kk] for kk in want_n}
            if f32:
                fwd_err = rel_l2(f"{name}: forward", out, want, F32_FWD_REL)
            else:
                fwd_err = compare(f"{name}: forward", out, want)
            bwd_err = max(rel_l2(f"{name}: d{c}", a, b,
                                 F32_BWD_REL if f32 else BWD_REL_L2,
                                 "autograd of the plain attention")
                          for c, a, b in zip("qkv", grads, want_grads))
            print(f"  {name}: launches {got_n} (expected {want_n}); "
                  f"others {launches}", flush=True)
            if launches != {**{kk: 0 for kk in launches}, **want_n}:
                fail(f"{name}: launches {launches}, expected {want_n}")
            ring = SQ._Loopback(S)
            ql, kl, vl, gl = (ring.local(t) for t in (q, k, v, g))

            def fwd():
                return SQ.ring_forward(ql, SQ._Around(SQ.Chunk(kl, vl),
                                                      ring.pass_on, S))

            o, lse = fwd()

            def bwd():
                around = SQ._Around(SQ.Chunk(kl, vl), ring.pass_on, S,
                                    grads=True)
                return SQ.ring_backward(ql, around, o, lse, gl)

            ms = (time_ms(fwd)[0], time_ms(bwd)[0])
            for kind, t_ms, w_ms, err in (("fwd", ms[0], whole[0], fwd_err),
                                          ("bwd", ms[1], whole[1], bwd_err)):
                rows.append({"name": f"ring_attention_{kind}{suffix}",
                             "model": tag,
                             "shape": shape, "seq": S, "ms": t_ms,
                             "whole_kernel_ms": w_ms,
                             "bound_ms": bound[kind], "max_abs_err": err,
                             "launches": S})
                print(f"  {name}, {kind}: {t_ms:.4f} ms for {S} kernel "
                      f"calls on ({B * S}, {H}, {T // S}, {D}) chunks, one "
                      f"whole call {w_ms:.4f} ms ({t_ms / w_ms:.2f}x), "
                      f"bound {bound[kind]:.4f} ms; on {card}", flush=True)
            del out, grads, o, lse, leaves
        del q, k, v, g, plain, want, want_grads, whole_o, whole_lse
        torch.cuda.empty_cache()
    return rows


def _update_rel(got: dict, one: dict, start: dict) -> float:
    """||got - one|| / ||one - start|| over every parameter of three
    ``_host_params`` records: how far a run's update is from one device's
    update, relative to it."""
    import torch

    num = den = 0.0
    for n, w in one.items():
        if n is None:
            continue
        w = w.to("cuda", torch.float64)
        num += (got[n].to("cuda", torch.float64) - w).square().sum().item()
        den += (w - start[n].to("cuda", torch.float64)).square().sum().item()
    return (num / den) ** 0.5


def sp_pp_dit(card: str, one: tuple, call) -> dict:
    """Phase 25 (b): ``dit_forget`` under ``sp`` on data=1,seq=1 (every
    attention through the ring's path, one rank) and under ``pp`` on
    stage=1 in 1 and PP_MICROBATCHES microbatches, against phase 23's
    one-device run of the same weights, batches and mask."""
    from uurg_torch.parallel import make_mesh
    from uurg_torch.workloads.dit import DiTWorkload

    out = {}
    seq, stage = make_mesh({"data": 1, "seq": 1}), make_mesh({"stage": 1})
    for key, place in (("sp", {"mesh": seq, "parallelism": "sp"}),
                       ("pp1", {"mesh": stage, "parallelism": "pp",
                                "pp_microbatches": 1})):
        grp = call(place, profile=False)
        tag = (f"dit_forget {place['parallelism']} "
               f"({'seq=1' if key == 'sp' else 'stage=1, 1 microbatch'}, "
               f"{DP_DIT_STEPS} steps at {DIT_BATCH} + {DIT_BATCH})")
        res = _dp_compare(tag, card, one, grp)
        ema = _param_diff(grp[0]["ema"], one[0]["ema"])
        print(f"  EMA: largest difference {ema[0]:.3e}, relative L2 "
              f"{ema[1]:.3e}", flush=True)
        if not ema[1] <= DP_REL:
            fail(f"dit_forget's EMA under {key} differs from one device")
        res["ema_rel_l2"] = ema[1]
        out[key] = res
        del grp
        _collect()
    start = _host_params(perturb_dit_(DiTWorkload.build(DIT_NAME)
                                      .init_params(SEED)))
    _collect()
    M = PP_MICROBATCHES
    grp = call({"mesh": stage, "parallelism": "pp", "pp_microbatches": M},
               profile=False)
    tag = (f"dit_forget pp (stage=1, {M} microbatches, {DP_DIT_STEPS} steps "
           f"at {DIT_BATCH} + {DIT_BATCH})")
    big, rel = _param_diff(grp[0]["model"], one[0]["model"])
    upd = _update_rel(grp[0]["model"], one[0]["model"], start)
    want = {kk: M * v if kk.startswith("attention") else v
            for kk, v in one[1].items()}
    print(f"  {tag}: update relative L2 {upd:.3e} (gate {PP_UPDATE_REL}), "
          f"parameters' largest difference {big:.3e}, relative L2 "
          f"{rel:.3e}; launches {grp[1]} (expected {want}); {grp[2]:.3f} ms "
          f"(one device {one[2]:.3f}), each step's end at "
          f"{[round(t, 1) for t in grp[4]]} ms (one device "
          f"{[round(t, 1) for t in one[4]]}), peak {grp[3]:.3f} GiB (one "
          f"device {one[3]:.3f}); on {card}", flush=True)
    if not upd <= PP_UPDATE_REL:
        fail(f"{tag}: the update is {upd:.3e} from one device's")
    if grp[1] != want:
        fail(f"{tag}: launches {grp[1]}, expected {want}")
    out["pp2"] = {"update_rel_l2": upd, "max_abs": big, "rel_l2": rel,
                  "launches": grp[1], "ms": grp[2], "one_device_ms": one[2],
                  "peak_gib": grp[3], "one_device_peak_gib": one[3],
                  "step_ends_ms": grp[4], "one_device_step_ends_ms": one[4]}
    del grp, start
    _collect()
    return out


def sp_sd(card: str, one: tuple, call) -> dict:
    """Phase 25 (c): ``nsfw_removal`` under ``sp`` on seq=1 (SD's
    self-attention sites, T % 128 == 0, through the ring's path), against
    phase 23's one-device run."""
    from uurg_torch.parallel import make_mesh

    grp = call({"mesh": make_mesh({"seq": 1}), "parallelism": "sp"})
    tag = f"nsfw_removal sp (seq=1, {DP_SD_STEPS} steps at {SD_BATCH} + " \
          f"{SD_BATCH})"
    return _dp_compare(tag, card, one, grp)


def parallel_path(card: str, gen) -> dict:
    """Phase 23: data parallel and FSDP on a one-rank NCCL group (this
    process, a free localhost port), each run against the one-device run;
    the group is torn down at the end."""
    import torch
    import torch.distributed as dist

    from uurg_torch.parallel import initialize_distributed, make_mesh
    from uurg_torch.parallel.dist import free_port

    def group():
        initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cuda")
        print(f"  group: {dist.get_backend()}, world size "
              f"{dist.get_world_size()}", flush=True)

    try:
        out = {"ddpm": dp_ddpm(sfron_config(), card, group)}
        torch.cuda.empty_cache()
        mesh = make_mesh({"data": 1, "model": 1})
        out["dit"], dit_one, dit_call = dp_dit(card, mesh)
        torch.cuda.empty_cache()
        out["sd"], sd_one, sd_call = dp_sd(card, mesh, gen)
        torch.cuda.empty_cache()
        out["draws"] = dp_draw_cost(sfron_config(), card)
        banner(f"tensor parallel (uurg_torch/parallel, DIT_TP_RULES and "
               f"SD_TP_RULES) on the one-rank NCCL group, mesh data=1,"
               f"model=1, each against phase 23's one-device run: "
               f"dit_forget tp ({DP_DIT_STEPS} steps at {DIT_BATCH} + "
               f"{DIT_BATCH}, dense mask), nsfw_removal tp ({DP_SD_STEPS} "
               f"steps at {SD_BATCH} + {SD_BATCH}, packed mask), their last "
               f"step profiled")
        out["tp_dit"] = tp_dit(card, mesh, dit_one, dit_call)
        torch.cuda.empty_cache()
        out["tp_sd"] = tp_sd(card, mesh, sd_one, sd_call)
        banner(f"ring attention and the DiT pipeline (uurg_torch/parallel/"
               f"sequence.py, pipeline.py) on the one-rank NCCL group: the "
               f"ring's arithmetic over {RING_SEQS} ranks in one process at "
               f"{DIT_ATTN_SHAPE} and {RING_SD_SHAPE}; dit_forget sp "
               f"(data=1,seq=1) and pp (stage=1, 1 and {PP_MICROBATCHES} "
               f"microbatches), nsfw_removal sp (seq=1), each against "
               f"phase 23's one-device run, their last step profiled")
        out["ring_loopback"] = ring_loopback(card, gen)
        out["sp_pp_dit"] = sp_pp_dit(card, dit_one, dit_call)
        del dit_one
        torch.cuda.empty_cache()
        out["sp_sd"] = sp_sd(card, sd_one, sd_call)
        del sd_one
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["launches"] = {"ddpm": out["ddpm"]["training"]["launches"],
                       "sampling": out["ddpm"]["sampling"]["launches"],
                       "dit": out["dit"]["launches"],
                       "sd": out["sd"]["launches"],
                       "dit_tp": out["tp_dit"]["launches"],
                       "sd_tp": out["tp_sd"]["launches"],
                       **{f"dit_{k}": v["launches"]
                          for k, v in out["sp_pp_dit"].items()},
                       "sd_sp": out["sp_sd"]["launches"]}
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "uurg_torch", "csrc")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(uurg_torch/ not found beside it)", file=sys.stderr)
        return 2
    import shutil

    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from uurg_torch.ops import _build
    from uurg_torch.ops.flash_attention import attention
    from uurg_torch.ops.group_norm import group_norm
    from uurg_torch.workloads import ddpm_runner as R
    from uurg_torch.workloads.ddpm import DDPMWorkload

    t_start = time.time()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    banner(f"card: {card}")
    print(f"== torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {sh([_build._nvcc(), '--version']).splitlines()[-1]}",
          flush=True)

    banner("build")
    t0 = time.time()
    warmup = bytecode_warmup()        # beside nvcc, for phase 14b's CLIs
    _build.build_all()
    print(f"  built {len(_build.sources())} sources in "
          f"{time.time() - t0:.1f} s (nvcc, one a source: "
          + ", ".join(f"{n} {t:.1f} s"
                      for n, t in sorted(_build.build_seconds.items()))
          + ")", flush=True)
    for name, log in sorted(_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "(C75" in line:
                print(f"  [{name}] {line.strip()[:200]}")
            if re.search(r"[1-9]\d* bytes spill (stores|loads)", line):
                fail(f"ptxas reports register spills in {name}")

    config = sfron_config()
    wl = DDPMWorkload.from_config(config)          # CUDA, bf16 compute

    class Args:
        ckpt_folder = None
        seed = SEED

    model = R.load_params(Args, config, wl)
    n_params = sum(p.numel() for p in model.parameters())
    banner(f"model: full-width CondUNet, {n_params} parameters, "
          f"seeded random init")
    sites = collect_sites(model, wl.device)
    n_attn = sum(1 for s in sites if s[0] == "attn")
    n_gn = sum(1 for s in sites if s[0] == "gn")
    print(f"  sites per forward: {n_attn} attention, {n_gn} GroupNorm",
          flush=True)

    banner("kernels vs plain versions (bf16, CFG batch "
          f"{2 * SAMPLING_BATCH})")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = check_kernels(sites, 2 * SAMPLING_BATCH, gen)

    banner("whole model, kernels vs plain path")
    model_rel = model_check(model, gen)

    banner(f"main path: sample_images, DDIM-{DDIM_STEPS}, CFG "
          f"{COND_SCALE}, {SAMPLING_BATCH} labels")
    labels = np.arange(SAMPLING_BATCH) % config.data.n_classes
    R.sample_images(Args, config, model, labels[:8], num_steps=2,
                    cond_scale=COND_SCALE, batch_size=SAMPLING_BATCH,
                    seed=SEED)                         # warm-up, not counted
    finite = []
    hook = model.register_forward_hook(
        lambda mod, args, out: finite.append(torch.isfinite(out).all()))
    torch.cuda.synchronize()
    attention.launches = 0
    group_norm.launches = 0
    t0 = time.time()
    imgs = R.sample_images(Args, config, model, labels,
                           num_steps=DDIM_STEPS, cond_scale=COND_SCALE,
                           seed=SEED)
    elapsed = time.time() - t0
    launches = {"attention_fwd": attention.launches,
                "group_norm_fwd": group_norm.launches}
    hook.remove()
    if not (isinstance(imgs, np.ndarray) and imgs.dtype == np.uint8
            and imgs.shape == (SAMPLING_BATCH, 32, 32, 3)):
        fail(f"sample_images returned {type(imgs)} "
             f"{getattr(imgs, 'dtype', None)} {getattr(imgs, 'shape', None)}")
    if len(finite) != DDIM_STEPS or not all(bool(f) for f in finite):
        fail("a UNet output of the sampling loop is not finite")
    if imgs.std() == 0:
        fail("sampled images are constant")
    want = {"attention_fwd": n_attn * DDIM_STEPS,
            "group_norm_fwd": n_gn * DDIM_STEPS}
    print(f"  launches: {launches} (expected {want})")
    if launches != want:
        fail("not every attention/GroupNorm site went through its kernel")
    print(f"  {SAMPLING_BATCH} images in {elapsed:.3f} s: "
          f"{SAMPLING_BATCH / elapsed:.3f} imgs/s on {card}; every UNet "
          f"output finite; image mean {imgs.mean():.2f} std "
          f"{imgs.std():.2f}", flush=True)

    banner(f"backward kernels vs plain versions (bf16, training batch "
          f"{TRAIN_BATCH})")
    rows += check_bwd_kernels(sites, TRAIN_BATCH, gen)

    banner("whole model gradients, kernels vs plain path")
    grad_rel = grad_check(model, wl, gen)
    del model
    torch.cuda.empty_cache()

    banner(f"main path: sfron_forget, full width, batch {TRAIN_BATCH} "
          f"forget + {TRAIN_BATCH} remain, {WARMUP_STEPS} warm-up + "
          f"{TRAIN_STEPS} counted steps")
    train = train_path(config, card, n_attn, n_gn)

    banner("attention kernels off the main path (ragged T, padded D)")
    ragged = check_ragged(gen)

    banner("GroupNorm forward off the main path (fp32, ragged slices, "
          "split route, small batches)")
    gn_offpath = check_gn_offpath(gen)

    banner("GroupNorm backward off the main path (fp32, ragged slices, "
          "split route, small batches, batch 256)")
    gn_bwd_offpath = check_gn_bwd_offpath(gen)

    banner(f"main path: Fisher and masks, full width, CFG {COND_SCALE}, "
          f"batch {TRAIN_BATCH} of each split")
    fisher = fisher_path(config, card, n_attn, n_gn, gen)

    banner(f"main path: Selective Amnesia, full width, the per-sample "
          f"Fisher ({FIM_CHUNKS} chunks x {FIM_SAMPLES} examples) and "
          f"{SA_WARMUP_STEPS} + {SA_STEPS} SA steps at batch {TRAIN_BATCH}")
    sa = sa_path(card, n_attn, n_gn, gen)

    banner("evaluation: InceptionV3 and the ResNet-34 probe, card vs CPU, "
          "throughput")
    evaluation = eval_networks(card)
    torch.cuda.empty_cache()
    banner(f"main path: the north-star pipeline through the CLIs, each "
           f"python -m uurg_torch.cli.<name> in a process of its own at full "
           f"width: train pretrain ({PIPE_ITERS} iterations), "
           f"generate_fisher, sfron ({PIPE_ITERS} steps, held to the "
           f"in-process run bit for bit), sample ({PIPE_SAMPLES} a class of "
           f"9, DDIM-{DDIM_STEPS}), evaluator, classifier_evaluation; beside "
           f"them in this process the five stages end to end (the twin of "
           f"cli/parity_check.py) at full width, {PARITY_ITERS} SFR-on steps, "
           f"{PARITY_SAMPLES} + {PARITY_PROBE} samples DDIM-{DDIM_STEPS}")
    pipeline, parity, pipeline_finish = pipeline_path(
        card, n_attn, n_gn, warmup,
        alongside=lambda: parity_path(config, card, n_attn, n_gn))
    del config, wl
    torch.cuda.empty_cache()
    banner(f"main path: classification, ResNet-18 (CIFAR stem, full width) "
          f"on a {CLS_TRAIN}-image stand-in, random 10% forgetting, batch "
          f"{CLS_BATCH}: card vs CPU, SFRon chunked as CUDA graphs (bf16 "
          f"{CLS_SCAN_ITERS}, fp32 {CLS_F32_ITERS} of 1,500 "
          f"iterations) and bf16 step by step ({CLS_WARMUP} + "
          f"{CLS_TIMED}), the other eight methods at one epoch, the "
          f"main_random CLI")
    classification = classification_path(card)

    banner("float32 attention kernels vs plain versions (TF32 off): "
          "ViT-B/16 at 224 and 32 px, padded D, ragged T")
    rows_f32, f32_detail = attention_f32_path(gen)
    banner(f"main path: ViT-B/16 (fp32 and bf16) and Swin-T classification "
          f"at {VIT_RES} px: card vs CPU, SFRon at batch {VIT_BATCH} "
          f"({VIT_SCAN_ITERS} of 1,500 iterations in CUDA-graph chunks of "
          f"{VIT_SCAN_CHUNK}, {VIT_WARMUP} + {VIT_TIMED} step by step), "
          f"main_random "
          f"--model ViT_B, save_base_dataset, train_classifier, "
          f"classifier_evaluation")
    vit = vit_path(card)
    torch.cuda.empty_cache()
    pipeline_finish()                  # phase 14b's evaluation, long done
    banner(f"main path: the remat'd DDPM step (full width, batch "
          f"{TRAIN_BATCH}, Adam nu in bf16) against no remat")
    remat = remat_path(sfron_config(), card, n_attn, n_gn)
    rows += rows_f32
    torch.cuda.empty_cache()
    banner(f"main path: {DIT_NAME} class forgetting on {DIT_LATENTS} "
           f"stand-in latents: the attention kernels at "
           f"{DIT_ATTN_SHAPE} (bf16) and {DIT_F32_SHAPE} (fp32), the model "
           f"vs its plain path and card vs CPU, the three DiT CLIs, "
           f"{DIT_WARMUP} + {DIT_STEPS} SFR-on steps at batch {DIT_BATCH} "
           f"under full and attn remat, the sample grid")
    dit = dit_path(card, gen)
    banner(f"main path: the frozen VAE (VAEConfig, fp32) at {VAE_RES} px: "
           f"the float32 attention forward at head width 512 (xwide) vs "
           f"plain at T up to 4096 and timed at {VAE_ATTN_SHAPE}, the "
           f"GroupNorm forward at the VAE's sites at batch {VAE_BATCH}, "
           f"encode and decode card vs CPU and at batch {VAE_BATCH}, "
           f"encode_latents, forget from its shards and from an image "
           f"folder, dit_sample --mode fid_npz")
    vae = vae_path(card, gen)
    torch.cuda.empty_cache()
    banner(f"the xwide attention kernels at padded head widths "
           f"{XW_WIDTHS[0]}-{XW_WIDTHS[-1]} (bf16 forward, fp32 and bf16 "
           f"backward) vs plain, timed at {XW_UNET_CFG}, {XW_UNET_TRAIN} "
           f"bf16 and {VAE_ATTN_SHAPE} fp32; the CondUNet at model.ch "
           f"{WIDE_CH} and a VAE encode's gradient vs their plain paths")
    width = xwide_width_path(card, gen)
    banner(f"main path: Stable Diffusion (the CompVis v1 UNet, bf16, remat; "
           f"CLIP ViT-L/14 text; the VAE at {SD_RES} px; seeded init): the "
           f"attention kernels at its three (T, D) and GroupNorm at its site "
           f"shapes at batch {SD_BATCH}, the UNet vs its plain path under "
           f"both remat policies, a Fisher batch by kernel family, "
           f"make_sampler ddim / plms / lms ({SD_SAMPLE_STEPS} steps, "
           f"{SD_PROMPTS} prompts) and decode, sd_generate_fisher "
           f"({SD_FISHER_BATCHES} of 50 batches)")
    work = tempfile.mkdtemp(prefix="uurg_sd_")
    try:
        sd = sd_path(card, gen, work)
        torch.cuda.empty_cache()
        banner(f"main path: Stable Diffusion's unlearning methods at full "
               f"width: the SD mask layout of generate_fisher_mask, "
               f"nsfw_removal's SFR-on step at batch {SD_BATCH} + "
               f"{SD_BATCH} ({SD_SFRON_WARMUP} + 1 + {SD_SFRON_TIMED} steps "
               f"under the Fisher mask dense and packed, one under xattn), "
               f"the prox, the five method CLIs (nsfw_removal and "
               f"train_esd at {SD_CLI_ITERS} steps, the three baselines at "
               f"{SD_BASELINE_ITERS})")
        sd_methods = sd_methods_path(card, gen, work)
        torch.cuda.empty_cache()
        banner(f"main path: Stable Diffusion's evaluation from "
               f"nsfw_removal's final.pt: generate_images (lms "
               f"{SD_EVAL_LMS_STEPS} steps on one case, ddim and plms "
               f"{SD_SAMPLE_STEPS} steps on three; {SD_EVAL_SAMPLES} images "
               f"a case at {SD_RES} px), imageclassify (ResNet50), "
               f"nudenet_classes (recorded heads), compute_fid")
        sd_eval = sd_eval_path(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    banner(f"data parallel and FSDP (uurg_torch/parallel) on a one-rank "
           f"NCCL group, each against one device: sfron_forget "
           f"({DP_DDPM_STEPS} steps at {TRAIN_BATCH} + {TRAIN_BATCH}) and a "
           f"DDIM-{DDIM_STEPS} batch of sample_images, dit_forget fsdp "
           f"({DP_DIT_STEPS} steps at {DIT_BATCH} + {DIT_BATCH}, dense "
           f"mask), nsfw_removal fsdp ({DP_SD_STEPS} steps at {SD_BATCH} + "
           f"{SD_BATCH}, packed mask), their last step profiled; the global "
           f"draws at data={DP_DRAW_RANKS}")
    par = parallel_path(card, gen)
    sd["launches"].update(sd_methods["launches"])
    sd["launches"].update(sd_eval["launches"])
    sd["launches"]["sd_fsdp"] = par["launches"]["sd"]
    sd["launches"]["sd_tp"] = par["launches"]["sd_tp"]
    sd["launches"]["sd_sp"] = par["launches"]["sd_sp"]
    dit["launches"]["dit_fsdp"] = par["launches"]["dit"]
    for key in ("dit_tp", "dit_sp", "dit_pp1", "dit_pp2"):
        dit["launches"][key] = par["launches"][key]
    # the SD paths' VAE encodes and decodes run the float32 attention
    # (xwide) too: their launches on the VAE's row, their GroupNorm
    # launches on the SD rows with the UNet's
    vae["launches"]["sd"] = {
        "attention_fwd_f32": sum(v.get("attention_fwd_f32", 0)
                                 for v in sd["launches"].values()),
        "group_norm_fwd": 0}

    fwd_per = "UNet forward at batch 256 (sampling)"
    bwd_per = "UNet backward at batch 128 (one SFR-on phase)"
    meta = {
        "attention_fwd": {
            "source": "uurg_torch/csrc/flash_attention_fwd.cu",
            "replaces": "uurg_tpu/ops/flash_attention.py:49", "per": fwd_per},
        "attention_bwd": {
            "source": "uurg_torch/csrc/flash_attention_bwd.cu",
            "replaces": "uurg_tpu/ops/flash_attention.py:113", "per": bwd_per},
        "group_norm_fwd": {
            "source": "uurg_torch/csrc/group_norm.cu",
            "replaces": "uurg_tpu/ops/group_norm.py:38", "per": fwd_per},
        "group_norm_bwd": {
            "source": "uurg_torch/csrc/group_norm.cu",
            "replaces": "uurg_tpu/ops/group_norm.py:60", "per": bwd_per},
        "attention_fwd_f32": {
            "source": "uurg_torch/csrc/flash_attention_f32.cu",
            "replaces": "uurg_tpu/ops/flash_attention.py:49",
            "per": f"ViT-B/16 forward at batch {F32_VIT_SHAPE[0]}, "
                   f"{VIT_RES} px (fp32)"},
        "attention_bwd_f32": {
            "source": "uurg_torch/csrc/flash_attention_f32.cu",
            "replaces": "uurg_tpu/ops/flash_attention.py:113",
            "per": f"ViT-B/16 backward at batch {F32_VIT_SHAPE[0]}, "
                   f"{VIT_RES} px (fp32)"},
    }
    # the DDPM paths read the four bf16/GroupNorm counters; the paths from
    # phase 15 on read the float32 routes' too
    ddpm_paths = {"training": train["launches"], "fisher": fisher["launches"],
                  "sa_fim": sa["fim_launches"], "sa": sa["sa_launches"],
                  "parity": parity["launches"],
                  **{f"cli_{k}": v for k, v in pipeline["launches"].items()},
                  "dp_training": par["launches"]["ddpm"],
                  "dp_sampling": par["launches"]["sampling"]}
    all_paths = {"classification": classification["launches"],
                 "vit_f32": vit["vit_sfron_f32"]["launches"],
                 "vit_f32_per_step": vit["vit_sfron_f32_per_step"]["launches"],
                 "vit_bf16": vit["vit_sfron_bf16"]["launches"],
                 "vit_bf16_per_step":
                     vit["vit_sfron_bf16_per_step"]["launches"],
                 "swin": vit["swin_sfron"]["launches"],
                 "remat": remat["launches"], **dit["launches"]}
    by_path = {}
    for name in meta:
        paths = {}
        if not name.endswith("_f32"):
            paths["sampling"] = launches.get(name, 0)
            paths.update({p: got[name] for p, got in ddpm_paths.items()})
        paths.update({p: got[name] for p, got in all_paths.items()})
        by_path[name] = paths
    kernels = summarise(rows, by_path, meta)
    # the bf16 pair at DiT-XL/2's shape, per DiT pass (DIT_BLOCKS launches
    # at DIT_ATTN_SHAPE); launches over phase 18's main-path runs
    for row in dit["rows"]:
        name = row["name"]
        paths = {p: dit["launches"][p][name] for p in dit["launches"]}
        kernels.append({
            "name": f"{name}_dit", "route": "cuda",
            "source": meta[name]["source"],
            "replaces": meta[name]["replaces"],
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": row["max_abs_err"],
            "ms": DIT_BLOCKS * row["views_ms"],
            "eager_ms": DIT_BLOCKS * row["views_eager_ms"],
            "library_ms": DIT_BLOCKS * row["library_views_ms"],
            **{k: DIT_BLOCKS * row[k] for k in ("plain_ms", "bound_ms")},
            "bound_by": row["bound_by"], "pad_ops": row["pad_ops"],
            "per": f"{DIT_NAME} {'forward' if 'fwd' in name else 'backward'}"
                   f" at batch {DIT_BATCH}: {DIT_BLOCKS} launches at "
                   f"{DIT_ATTN_SHAPE} (head width 72 at its true width, "
                   f"q, k, v views of MHSA's fused projection), device ms "
                   f"by CUDA-graph replay; library: bf16 SDPA on the "
                   f"same views",
        })
    kernels += vae_kernel_rows(vae, meta)
    kernels += xwide_kernel_rows(width, meta)
    kernels += sd_kernel_rows(sd, meta)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_detail.json"),
              "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "per_shape": rows,
                   "kernels": kernels, "model_rel_l2": model_rel,
                   "model_grad_rel_l2": grad_rel,
                   "sampling": {"images": SAMPLING_BATCH,
                                "steps": DDIM_STEPS, "seconds": elapsed,
                                "imgs_per_s": SAMPLING_BATCH / elapsed},
                   "training": train, "ragged_attention": ragged,
                   "gn_offpath": gn_offpath,
                   "gn_bwd_offpath": gn_bwd_offpath, "fisher": fisher,
                   "sa": sa, "evaluation": evaluation, "parity": parity,
                   "classification": classification,
                   "attention_f32": f32_detail, "vit": vit,
                   "pipeline": pipeline, "remat": remat, "dit": dit,
                   "vae": vae, "width": width, "sd": sd,
                   "sd_methods": sd_methods, "sd_eval": sd_eval,
                   "parallel": par,
                   "phase_starts": PHASE_STARTS,
                   "build_seconds": _build.build_seconds,
                   "profiler_misses": PROFILER_MISSES,
                   "total_seconds": time.time() - t_start}, f, indent=1,
                  default=str)
    if PROFILER_MISSES:
        print(f"  timed by CUDA events where the profiler saw no device "
              f"time: {PROFILER_MISSES}", flush=True)
    print(f"== done in {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
