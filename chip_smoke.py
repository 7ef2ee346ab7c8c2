#!/usr/bin/env python3
"""Start lightningfastspeech2_tpu_torch on one Hopper card and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card (name and power limit from nvidia-smi, capability (9, 0)
   asserted). f32 convolutions and products run in full f32: TF32 is off
   for cuDNN and cuBLAS, so f32 comparisons measure the kernels alone.
2. build: nvcc builds every kernel in csrc/ for sm_90a, all in parallel;
   the bf16 FFN kernels' SASS must hold HGMMA and ptxas must report no
   spill and no serialised wgmma for them; the 16 tensor-core
   ``lvc_stack`` kernels (bf16 and f32 at C = 16, 32, 64, 128, exact and
   Padé gate) must hold HMMA and spill nothing in f32 and at C = 32, and the
   32 CUDA-core ones spill nothing in f32; the eleven
   split-TF32 ``resblock`` kernels (f32 at C = 8, 16, 32, 64, 128 with x
   in shared memory or in L2, and C = 256 in clusters of 4) and the 24
   split-TF32 FFN kernels (``ffn_tf32_kernel`` and ``ffn_dup_tf32_kernel``
   at every C and both row counts) must hold HMMA and spill nothing; the
   eight soft-DTW kernels (``soft_dtw_wave_fwd`` and ``soft_dtw_wave_bwd`` at
   each rows-a-thread the plan takes) must spill nothing and hold no
   local-memory access; ``ffn_wide_kernel`` (C = 384, 512, 640) must hold
   HGMMA in bf16 and HMMA without a spill byte in f32, the split-TF32 flash
   kernels at head dims 128 and 256 HMMA, the wgmma flash kernels HGMMA, and
   the other spills and serialised wgmma of these and of the CUDA-core
   flash route are reported; the kernels past C = 256 (phase 32): the
   product of ``csrc/gemm_mma.cuh`` at each of its epilogues (ten in
   ``csrc/ffn_wide.cu``, four in ``csrc/resblock.cu``'s wide route) must
   hold HMMA and, in f32, spill nothing, and ``csrc/ffn_wide.cu``'s 16
   row and depthwise kernels (the long-row LN kernels past C = 768 among
   them) spill nothing in f32.
3. probe: the launch probe against ``2 * x``, its time beside
   ``torch.mul``'s, and the host µs per launch of the launch path before
   ``kernels/launch.py`` and of today's, in turns, with a launch's pieces.
4. kernels: each kernel against its plain PyTorch version on the card at the
   serving path's shapes, with its time (CUDA events, warmed up, L2 warm),
   the plain version's time, and its bound at the H100's published peaks.
   The resblock rows (HiFi-GAN V1 at a 512-frame mel, B=1, bf16 and f32)
   add the launch as the library recorded it (tile, blocks_per_launch,
   shared memory, each held against the tile plan), the route, where x
   lies and the halo share, achieved TFLOP/s,
   ``x_bound`` (time over bound: f32 products at split TF32's 165 TFLOP/s,
   ``bound_ms_cuda_cores`` at 67 beside it; the f32 plain version is the
   chain as f32 cuDNN convs with TF32 off) and, for bf16,
   ``cudnn_bf16_chain_ms``: the same chain as bf16 ``F.conv1d`` calls, a
   chain of library calls, not one (so no ``library_ms``).
5. serving (the main path): the flagship LightSpeech (bf16) and HiFi-GAN V1
   (bf16) built from seeded generators serve sentences through
   ``SpeechGenerator.generate_from_text`` and one batch of 8 through
   ``generate_samples`` at frame bucket 512. The duration head's bias is
   taken first, on the CPU. Then every launch counter is set to 0, the
   models are built, the requests served, and the counters read: each must
   equal what the path launches, and none may be 0. Then the batch again,
   five times on the host clock (median and spread), and one 512-frame
   vocoder call, in bf16 and in f32 (the generate CLI's default
   ``--vocoder_precision 32``, the split-TF32 resblock route), the median
   of ``HIFIGAN_CALL_RUNS`` on the host clock and one under the profiler:
   device ms and the resblock kernels' ms, share and launches (6 each).
6. reference: an f32 request on the card against the same request through
   the plain path on the CPU.
7. train kernels: ``ffn_ln_train`` (forward and backward) at every FFN
   block's shape of the training step, each held against the plain
   version's output and gradients, each launch's grid and shared memory as
   the library recorded them held against ``ops/ffn.py ffn_plan`` (phase 4
   does the same for the serving ``ffn_ln``); ``flash_attention`` (forward
   and backward) against the plain
   version, with ``F.scaled_dot_product_attention`` (same mask and
   dropout_p) timed as the library yardstick: bf16 at the decoder's shape
   (the wgmma kernels of ``csrc/flash_attention_sm90.cu``), f32 at phase
   9's shape (the split-TF32 mma.sync kernels of
   ``csrc/flash_attention.cu``), each with its build seconds and the
   launches by route it made. The f32 route of ``ffn_ln_train`` (split
   TF32) at phase 9's shapes (encoder B=2, P=128, k 5/25/13/9; decoder
   B=2, T=1024, k 17/21/9/13), each held against the plain version (TF32
   off, b1 moved off the ReLU kink), its launches against ``ffn_plan``,
   with its bound at split TF32's 165 TFLOP/s and at the CUDA cores' 67,
   and the time of its products alone as f32 ``torch.matmul`` calls.
8. training (this slice's main path): the flagship in bf16 with f32
   parameters takes 1 warm-up and 5 timed optimizer steps on B=8, P=256,
   T=2048 teacher-forced batches at the config dropout rates. Every loss
   must be finite, every parameter must get a finite non-zero gradient,
   and the launch counters, set to 0 just before, must equal 8 / 8 / 4 / 4
   per step, every flash launch through the wgmma kernels. One more step
   runs under torch.profiler for the time split, with flash attention's
   share of the kernel time.
9. train reference: one f32 step on the card against the same step on the
   CPU's plain path (flagship widths, B=2, T=1024, dropout rates 0,
   warm-up 1 so the first update is visible), its flash launches through
   the split-TF32 kernels of ``csrc/flash_attention.cu``; the counted
   step's FFN launches, and one more card step under torch.profiler: the
   FFN kernels' ms and launches.
10. soft-DTW kernels: ``soft_dtw`` (forward and backward) at the mel loss's
    lattices (8 items x 8 chunks of 256 frames, D from 80 mel channels,
    gamma 0.1) against the plain recurrence's value and autograd gradient,
    each kernel alone against its plain twin (the forward's residual of
    softmin weights, the backward on the plain residual), each launch as
    the library recorded it against ``ops/soft_dtw.py soft_dtw_plan``, with
    the byte bound of the function's own bytes (D in and one float a cell
    out; that float in and dD out) and the bytes the kernels' residual of
    three floats a cell moves beyond it;
    the length regulator's two kernels at the flagship's (8, 256, 256) bf16
    -> 2048 frames with int64 durations against the gather (forward bit for
    bit, the running sums it writes, the gradient within one bf16 ulp), each
    kernel's device ms a launch from torch.profiler beside its event ms and
    the whole call's host µs, with the gather timed as the library
    yardstick; one regulator call must run one device kernel forward and
    one backward, by the profiler's count.
11. soft-DTW training (this slice's main path): phase 8's step with
    ``mel_loss="soft_dtw"`` and ``LFS2_PALLAS_LR=1`` set in the process, 1
    warm-up and 3 timed steps; the launch counters, set to 0 just before,
    must equal the per-step counts derived from the config (now also
    ``soft_dtw``, ``soft_dtw_bwd``, ``regulate``, ``regulate_bwd``), and one
    profiled step gives the soft-DTW kernels' share.
12. soft-DTW train reference: phase 9 with the soft-DTW mel loss and the
    regulator flag set, card against CPU.
13. step comparison: phases 8 and 11's trainers take one more step each,
    interleaved, ``STEP_PAIRS`` times (outside the counted runs); the
    median of each and of their per-pair difference.

14. FastDiff kernels: ``lvc_stack`` (the LVC chain of one upsample stage)
    against its plain version at a 512-frame bucket, B=1: stages 1, 2 and 3
    in bf16 and f32 and one Padé-gate case, each with the launch as the
    library recorded it held against ``ops/fastdiff_lvc.py lvc_plan``, its
    bound (bytes and operations, bf16 at the tensor cores' peak, f32 as
    split-TF32 products) and the plain version's time.
15. FastDiff serving (this slice's main path): the flagship with its
    residual mel head and the FastDiff vocoder (reference widths, N=4), both
    bf16 from seeded generators, serve phase 5's sentences and batch after
    the same duration bias; the counters, set to 0 just before, must show
    ``lvc_stack`` at 2 per ε pass (stages 2 and 3) and no resblock launch.
    Then one request with ``LFS2_FUSED_STAGE1=1`` (3 per pass), and one
    512-frame vocoder call timed and profiled in bf16 and in f32 (the
    generate CLI's default vocoder precision): the median of
    ``FD_CALL_RUNS`` calls, device ms and ``lvc_stack`` ms.
16. FastDiff reference: an f32 FastDiff request on the card against the
    same request on the CPU's plain path, with the same noise drawn once on
    the CPU.
17. generate CLI: port checkpoints of the flagship (pitch and energy
    priors, two d-vector speakers, the prior and d-vector GMMs as the
    port's LogGMMs) and of the joint model (+ FastDiff) are written under
    ``_chip/``, and ``cli.generate.main`` serves a sentence with an
    out-of-vocabulary word with ``--prior_strategy gmm --sample_dvector``:
    f32 HiFi-GAN V1 (the CLI's default), ``--vocoder_precision 16``,
    ``--restore true --augment_gaussian_snr true`` and ``--use_fastdiff true
    --fastdiff_n 4``. Each wav must be finite, non-empty and at 22.05 kHz
    (44.1 kHz restored); per run one line: the host ms of
    ``generate_from_text`` (median of 5 after a warm call), its device ms,
    and per kernel route its device ms, launches and bound at the request's
    buckets (B=1), which must show ``ffn_ln``'s f32 kernel in every run, the
    f32 resblock kernels (f32 runs), the bf16 ones (bf16 run) and
    ``lvc_stack`` (FastDiff). The f32 run's waveform must agree with the
    same CLI run with ``--device cpu`` within phase 6's tolerance, and the
    neural G2P must spell the OOV word on the card as on the CPU. Then each
    kernel route alone at the request's shapes against its plain version.

18. wide FFN: ``ffn_ln`` at C = 640 (B, T = 1, 256 and 8, 512; k = 5, 17,
    25; and 1, 32, k = 5, an encoder launch at a sentence's phones) and at
    C = 384 and 512 (8, 512, k = 17), F = 4 C, in bf16 and f32, through
    ``ffn_wide_kernel`` and its LN2 pass, each against ``ffn_ln_plain``
    with both launches as the library recorded them held against
    ``ffn_plan`` (grid, cluster, shared memory; the F splits and the
    clusters the card holds at once beside them), its time and its bound.
19. wide flash: flash attention forward and backward at (2, 2, 2048, 256)
    (the tensor-core routes' D = 256 templates) and (1, 1, 1024, 512) (the
    CUDA-core route), bf16 and f32, against the plain version, with SDPA
    timed beside them.
20. lightspeech_true76m serving: the preset with HiFi-GAN V1, bf16 and f32,
    from seeded generators, serves phase 5's sentences and batch; the
    counters, set to 0 just before each run, must show ``ffn_ln`` at C =
    640 in every block of every pass (``ffn_ln.by_width``); after each
    counted run ``ffn_ln``'s device ms (torch.profiler) in the longest
    request and in the batch; then an f32 request on the card against the
    CPU's plain path (phase 6's tolerance).
21. lightspeech_true76m training: bf16 with f32 parameters and bf16 Adam
    moments, B=8, P=256, T=2048, 1 warm-up and 3 timed steps; finite losses,
    a finite non-zero gradient on every parameter, first moments in bf16;
    the counters must show every decoder flash launch through the wgmma
    kernels and no ``ffn_ln_train`` launch (the JAX gate's fit estimate
    sends (640, 2560) to the unfused FFN); one profiled step, with the
    optimizer's host and device share of it and ``optimizer.step()`` alone
    (its kernels a call, device ms, host ms).
22. fastspeech2_27m: the preset (plain ConvFFN, no speaker) with HiFi-GAN
    V1 in bf16 serves phase 5's sentences and batch (no ``ffn_ln`` launch:
    its blocks run unfused); then ``cli.generate.main`` serves a sentence
    from a port checkpoint of it with a ResBlock2 vocoder directory
    (HiFi-GAN V3's dims, plain convs: no resblock kernel launch).
23. every-layer embeddings: the flagship with every-layer speaker and prior
    embeddings serves one request and takes one training step (B=2, P=64,
    T=1024) in bf16, finite, through ``ffn_ln`` / ``ffn_ln_train`` in every
    block and flash in every decoder block.
24. head dims past 128 through the train step: the flagship at hidden 512
    (filter 2048: the unfused FFN) with 2 heads (head dim 256) and 1 (512),
    1 + 1 blocks, one step in bf16 and one in f32 at B=2, P=128, T=1024;
    the counters by (route, head dim), set to 0 just before each step, must
    show the decoder block's flash launch, forward and backward.

25. dataset: a make_rich_corpus corpus (4 speakers x 8 utterances) under
    ``_chip/``; ``TTSDataset`` on the card with the flagship's variances
    (frame-level pitch with CWT, energy, SNR) and pitch and energy priors,
    its stats computed there, held against the same dataset on the CPU with
    the CPU tests' tolerances: each utterance's frame features (pitch off
    the frames within ``YIN_MARGIN`` of a YIN decision), every item key for
    key, the stats and the priors; items a second on each, and one item's
    extraction's device ms and kernels (``device_kernels``); a
    ``PrefetchLoader`` with 2 spawn workers on the card, its batches in the
    synchronous ``batch_index_stream`` order, batches a second; then
    ``cli.generate.main --dataset`` from phase 17's flagship checkpoint with
    f32 HiFi-GAN V1: every utterance written, finite, at 22.05 kHz, its
    ``.meta`` the corpus's phones and durations, ``ffn_ln`` and the resblock
    kernels counted, and one profiled utterance through ``ffn_ln_f32`` and
    ``resblock_f32``; one collated item of the CPU dataset served on the card
    within phase 6's tolerance of the CPU generator, and as int32 equal to
    its int64 twin.

26. train CLI: ``cli.train.main`` on the card under ``_chip/``. A
    make_rich_corpus corpus of 4 speakers x 8 utterances of 2-14 s (batches
    of 8 reach frame buckets of 1024 and more); the flagship (pitch with
    CWT, energy, SNR; pitch, energy and duration priors) trains 20 steps in
    bf16 at batch 8 through a 2-worker loader, with d-vectors and
    ``--dvector_gmm``, ``--priors_gmm``, SWA, a validation set of 4 x 2
    utterances of 1-2 s, evals and checkpoints every 10 steps: every
    logged loss and eval metric finite, ``latest`` at step 20 and
    restoring into a model, the SWA
    checkpoint and both GMM pickles there, the serving ``ffn_ln``,
    ``ffn_ln_train`` and flash launched by the run. Its steps/s, host ms a
    step, the share of the loop spent waiting for the loader (with and
    without the first batch) and one more step of the trained model
    profiled. Then a 2-step warm start (every tensor restored), a 2-step
    soft-DTW run with ``LFS2_PALLAS_LR=1`` (``soft_dtw`` and ``regulate``
    launched), a 2-step f32 run (rates 0, B=2, frame bucket 1024, flash) on
    the card against the same run on the CPU through one feature cache
    (losses and ``grad_norm`` within ``TC_LOSS_REL``), one d-vector card
    against CPU, and the generate CLI serving the bf16 run's checkpoint with
    ``--prior_strategy gmm --sample_dvector``.

27. canonical joint: ``cli.train.main`` trains ``canonical_joint`` (the
    flagship acoustic stack with 6 decoder layers, the diffusion variance
    adaptor over pitch, energy, SNR and SRMR, the diffusion speaker
    generator and FastDiff fine-tuning; its flags held to the preset) on a
    make_rich_corpus corpus of 4 x 2 utterances of 9-12 s, in bf16 at batch
    4 and a frame bucket of 1024 or more for 6 steps: every branch's loss finite
    (mel, the four variances, duration, fastdiff, speakers),
    ``ffn_ln_train`` and flash launched, ``lvc_stack`` not (FastDiff trains
    on its plain route). One more step profiled, FastDiff's training
    forward and backward timed alone. A 2-step f32 run (rates 0, B=2) on
    the card against the same on the CPU through one feature cache: the
    first step within ``TC_LOSS_REL``, and the second replayed on the CPU
    from the card's own state within it; a 2-step flagship run with
    ``--duration_stochastic``;
    the generate CLI serving the joint checkpoint through FastDiff
    (``lvc_stack``) and HiFi-GAN (the resblock kernels), and the stochastic
    one; the corpus's per-window SRMR on the card within ``SRMR_REL`` of
    the CPU's. The ``kernels`` line gains ``launches_phase_27``.

28. HiFi-GAN training: ``cli.train_vocoder.main`` on the card under
    ``_chip/``. A make_corpus corpus of 8 wavs of 2-4 s; HiFi-GAN V1 at
    full width (the CLI's defaults: B = 16, segments of 8192, f32 with TF32
    off) trains 8 steps, a checkpoint every 4, and resumes for 2: every
    loss finite, no resblock kernel launched in training (the generator
    trains on its plain route), the host ms of each step, one more step
    profiled (device ms, its 10 largest kernels, peak memory). f32 means
    f32: the CLI in a subprocess on the card, one step of a 2048-sample
    segment at B = 2 from seeded weights, against the same with ``--device
    cpu`` (losses within ``VOC_F32_REL``; the same step in this process
    with TF32 on beside it). The generate CLI serves the V1 checkpoint with
    phase 17's acoustic checkpoint in f32 and bf16 (``resblock`` at C =
    256, ``resblock_trio`` at 128, 64, 32: ``by_width``). HiFi-GAN V2
    (``--upsample_initial_channel 128``) trains 2 steps and serves in both
    dtypes through ``resblock_trio`` at C = 64, 32, 16, 8; the trio and
    each resblock alone at C = 16 and 8 are held against their plain
    versions at the request's lengths, with time, bound and launches.
    Then C3 on the card: the kernels raise where a gradient is needed,
    and V1's training route gives every parameter a gradient. Rows 4-5 of
    the ``kernels`` line gain ``launches_phase_28`` and ``c16_c8``.

29. on-device features, G2P and denoiser training: ``cli.train.main
    --on_device_features True`` on phase 26's corpora anew: the flagship
    from raw int16 wavs, bf16, batch 8, 10 steps through a 2-worker loader
    with a validation set: every loss finite, ``ffn_ln_train`` and flash
    launched (``launches_phase_29``). The run's first batch: its features on
    the card with both TF32 flags on, timed (host, events, profiled device
    ms and kernels), against the same on the CPU (the mel linear within
    2e-6 of each item's peak and log10 1e-4 within 30 dB, energy and SNR
    within their rounding bounds, the pitch CWT where YIN decided alike)
    and, on float32 samples, against the CPU host pipeline's items at the
    JAX package's tolerances for the two paths; ``frame_srmr_padded`` over
    the batch on the card (time, peak) within ``SRMR_REL`` of the CPU; one
    more raw-mode step profiled with its peak. A 2-step f32 raw-mode run on
    the card against the same on the CPU (the first step's energy, duration
    and pitch within ``TC_LOSS_REL``; one step replayed on the CPU from the
    card's features, every loss within it). Then the G2P CLI (300 steps, d
    = 96, batch 256, the shipped lexicon: loss, held-out word accuracy and
    PER; the bundle reloaded, an OOV word decoded on the card) and the
    denoiser CLI (50 steps on the corpus's wavs; the npz reloaded, one
    ``apply_mask_net`` on the card).
30. data-parallel training: two ranks share the card over gloo under
    ``python -m torch.distributed.run --standalone --nproc_per_node 2
    chip_smoke.py --cli-rank RUNS`` (each rank runs ``cli.train.main``, the
    entry point ``-m lightningfastspeech2_tpu_torch.cli.train`` calls) on
    phase 26's corpora anew: the flagship in bf16 at the global batch 8 (4
    a rank), 10 steps through 2 loader workers a rank, with AdamW (and
    evals) and with ``--zero1`` (the parameters at step 2 alike); every
    rank's losses finite and equal to the other's, ``ffn_ln_train``, flash
    and ``ffn_ln`` launched on each (``launches_phase_30``); each rank's
    host ms a step, one profiled step's device ms, the gradient
    all-reduce's host ms (gloo, through the host), peak memory and
    optimizer bytes. An f32 step at global B = 2 of two ranks within
    ``DP_F32_REL`` of the same step in this process; then the mesh helpers
    in a world of one NCCL rank. Alone: ``python3 chip_smoke.py --parallel
    N`` (N ranks; on a machine of N cards, one rank a card over NCCL).
31. B16 widths and the tools: phase 5's sentences and batch through the
    flagship with a V1-shaped HiFi-GAN at ``upsample_initial_channel`` 384
    (stages 192, 96, 48, 24, which the resblock kernels run zero-padded to
    256, 128, 64, 32) in bf16 and in f32: launches counted by width, no
    signal padded on the way; the f32 request against the CPU (phase 6's
    tolerance); each width against its plain version at the 512-frame
    bucket with its time, the unpadded work's bound and the copy a direct
    call makes. Then ``cli.plot`` on phase 26's corpus without matplotlib,
    ``dio_pitch`` built on the host, one request under ``profile_trace``
    with an ``annotate`` span and the resblock kernels in the trace, and
    the resblock library's SASS through ``kernel_dump_to``. Rows 4-5 of the
    ``kernels`` line gain ``launches_phase_31`` and ``b16_widths``.

32. widths past C = 256 (ROADMAP B9t, B16w): the train CLI at hidden 512
    (4 heads, filter 1024, 4 + 4 blocks) on phase 26's corpus, 3 bf16
    steps with every FFN half through ``ffn_ln_train`` at C = 512
    (``csrc/ffn_wide.cu``; its launches by width equal to 8 a step), and
    one f32 step on the card against the CPU's within ``TC_LOSS_REL``; the
    training chain at each width of ``W_TRAIN`` (384-768, F up to 1152),
    bf16 at B = 8, T = 256 and 2048, f32 at phase 9's B = 2, T = 128 and
    1024, rate 0.1, against the plain
    version with every launch against ``ffn_plan`` (timed at the decoder
    shape at the widths a block builds), and ``ffn_ln`` served at C = 768 against
    its plain version; a HiFi-GAN at ``upsample_initial_channel`` 1024 trained
    3 f32 steps through the train_vocoder CLI and served with the hidden-512
    checkpoint through the generate CLI in f32 and bf16 (stage 0's
    ``resblock`` on the wide route at C = 512, 3 a call; ``ffn_ln`` at C =
    512), the f32 request against the CPU's (phase 6's tolerance), and the
    wide route at C = 512, 384 and 320 (run at 384) against its plain
    version at a 512-frame mel. The ``kernels`` line gains
    ``ffn_ln_train_wide``, ``ffn_ln_train_bwd_wide``, ``ffn_ln_c768`` and
    ``resblock_wide``.
33. inner widths (``inner_widths_phase``): the train CLI on phase 26's
    corpus for 2 bf16 steps with FastDiff at 64 inner channels, then the
    generate CLI with ``--use_fastdiff true`` on that checkpoint at
    ``--vocoder_precision`` 16 and 32 (``lvc_stack.by_width`` {64: 8} a
    request), the f32 request against the CPU's with the same noise;
    ``lvc_stack`` at C = 16, 48 (padded to 64), 64 and 128 in both dtypes at
    a 512-frame bucket's stages against its plain version, each launch
    against ``lvc_plan``; a hidden-1024 model (8 heads of 128, filter 1024,
    4 + 4 blocks) with HiFi-GAN V1 serving a batch through
    ``generate_samples`` in bf16 and f32 (``ffn_ln.by_width`` {1024: 12} a
    batch), the f32 batch against the CPU's; ``ffn_ln`` at C = 896, 1024,
    2048 and 4096 against its plain version. The ``kernels`` line gains
    ``launches_phase_33`` and ``lvc_by_width`` on ``lvc_stack`` and
    ``ffn_ln``, and the rows ``lvc_stack_c64`` and ``ffn_ln_c1024`` with
    every width.
34. past widths (``past_widths_phase``): the train CLI for 1 bf16 step at
    batch 1 with FastDiff at 256 inner channels (its kernel predictor at 8
    hidden channels) on a corpus of short utterances (its peak device
    memory printed), then the generate CLI with ``--use_fastdiff true`` on
    that checkpoint at ``--vocoder_precision`` 16 and 32
    (``lvc_stack.by_width`` {256: 8} a request: the wide route), the f32
    request against the CPU's with the same noise; ``lvc_stack`` at C =
    192, 256 and 512 in both dtypes at a 512-frame bucket's stages against
    its plain version; ``ffn_ln_train`` with its backward through autograd
    at C = 896, F = 768 (each {896: 1}); ``ffn_ln_train`` at C = 896, 1024
    and 2048 (bf16 at 8 x 256, f32 at 2 x 512) against its plain version.
    The ``kernels`` line gains ``launches_phase_34`` and the rows
    ``lvc_stack_wide``, ``ffn_ln_train_c896`` and ``ffn_ln_train_bwd_c896``
    with every width.

The flash kernels count launches by route and by (route, head dim): the
``kernels`` line gives the rows at head dims 256 and 512 the launches that
the main paths' counted runs (phases 5, 8, 9, 21) made there, and phase
24's beside them.

Phases 5 and 8 run without the flags and expect 0 launches of the kernels
of phases 10-12 and 14.

Then a ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before the result is printed. Without a CUDA device, or without the
repository beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import pickle
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,   # tensor cores
              torch.float32: 67e12}     # f32 without the tensor cores
PEAK_TF32_FLOPS = 495e12                # tensor cores, TF32
# f32-accurate products: the faster of the CUDA cores and split TF32 on the
# tensor cores (three TF32 products for each f32 one, 165 TFLOP/s)
PEAK_F32_ACCURATE = max(PEAK_FLOPS[torch.float32], PEAK_TF32_FLOPS / 3)
SAMPLING_RATE = 22050

SENTENCES = (
    "Hello world.",
    "The quick brown fox jumps over the lazy dog.",
    "A journey of a thousand miles begins with a single step, and so does "
    "this short test of the serving path.",
    "Speech synthesis turns written text into sound: the acoustic model "
    "predicts a mel spectrogram from the phones, and the vocoder turns that "
    "spectrogram into a waveform, one sample at a time, on the card.",
)
BATCH_TEXTS = SENTENCES + (
    "Seven silly swans swam silently seaward.",
    "Numbers and letters mix in this sentence.",
    "Please call Stella and ask her to bring these things with her.",
    "Rain in the valley, snow on the hills, and wind over everything.",
)
# mean rounded duration the untrained duration head is biased towards
FRAMES_PER_PHONE = 7.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, min_total_ms: float = 200.0, max_iters: int = 50) -> float:
    """Mean time of ``fn`` on the card: CUDA events around a run of calls
    after a warm-up call, enough calls to fill ``min_total_ms``."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    iters = int(min(max_iters, max(3, min_total_ms / max(a.elapsed_time(b), 1e-3))))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(flops: float, nbytes: float, dtype: torch.dtype, peak: float = None):
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate (the type's unless ``peak`` is given),
    whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err_and_tol(out: torch.Tensor, ref: torch.Tensor, f32_tol: float):
    """max |out - ref| and its tolerance: ``f32_tol`` in f32 (summation
    order only); in bf16 four units in the last place at the largest
    |ref|, since a one-ulp flip at a rounding point can carry through the
    residual chain."""
    err = (out.float() - ref.float()).abs().max().item()
    if out.dtype == torch.float32:
        return err, f32_tol
    top = ref.float().abs().max().item()
    return err, 4.0 * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)


def tensor_bytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ----------------------------------------------------------------- phases
def device_phase() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cap = torch.cuda.get_device_capability(0)
    info = {"phase": "device", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0), "capability": list(cap),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "allow_tf32": False}
    emit(info)
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"the port's kernels need capability (9, 0), got {cap}")
    return info


def build_phase() -> None:
    from lightningfastspeech2_tpu_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {k: v["seconds"] for k, v in report.items()}})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ptxas.txt").write_text(
        "\n".join(f"=== {k}\n{v['ptxas']}" for k, v in report.items()))
    ffn_sass_phase(report)
    soft_dtw_sass_phase(report)
    wide_sass_phase(report)
    chain_sass_phase(report)


# the FFN sources' tensor-core kernels, by their mangled names
FFN_WGMMA = re.compile(r"(ffn_ln_kernel|ffn_dup_kernel)ILi(\d+)E(?:Lb([01])E)?")
# lvc_stack's tensor-core kernels: lvc_mma_kernel<bf16 or float, C, Padé gate>,
# and its CUDA-core kernels: lvc_stack_kernel<bf16 or float, C, rows a chunk,
# Padé gate>
LVC_MMA = re.compile(r"(lvc_mma_kernel)I(13__nv_bfloat16|f)Li(\d+)ELb([01])E")
LVC_CORES = re.compile(r"(lvc_stack_kernel)I(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELb([01])E")
# resblock's split-TF32 kernels: f32_resblock_kernel<C, x in shared memory,
# blocks a row tile>
RESBLOCK_F32 = re.compile(r"(f32_resblock_kernel)ILi(\d+)ELb([01])ELi(\d+)E")
# the FFN sources' split-TF32 kernels: ffn_tf32_kernel<C, MT, chain> and
# ffn_dup_tf32_kernel<C, MT>
FFN_TF32 = re.compile(r"(ffn_tf32_kernel|ffn_dup_tf32_kernel)ILi(\d+)ELi(\d+)E(?:Lb([01])E)?")


@functools.lru_cache(maxsize=None)
def _sass_text(name: str) -> str:
    """cuobjdump's SASS of library ``name``, dumped once a run."""
    from lightningfastspeech2_tpu_torch.kernels import build

    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=300, check=True).stdout


def _sass_rows(name, report, pattern, key) -> dict:
    """Per kernel of library ``name`` matching ``pattern``: HGMMA and HMMA
    counts and local-memory instructions (LDL, STL) in cuobjdump's SASS,
    ptxas's spill bytes and C7512 warnings."""
    sass = _sass_text(name)
    rows = {}
    for block in re.split(r"\n\s+Function : ", sass)[1:]:
        m = pattern.search(block.split("\n", 1)[0])
        if m:
            rows[key(m)] = {"hgmma": len(re.findall(r"\bHGMMA", block)),
                            "hmma": len(re.findall(r"\bHMMA", block)),
                            "local": len(re.findall(r"\b(?:LDL|STL)\b", block)),
                            "spill_bytes": 0, "serialised_wgmma": False}
    current = None
    for line in report[name]["ptxas"].splitlines():
        m = pattern.search(line)
        if "Compiling entry function" in line:
            current = key(m) if m else None
        elif "C7512" in line and m:
            rows[key(m)]["serialised_wgmma"] = True
        elif current and "spill stores" in line:
            rows[current]["spill_bytes"] += int(re.search(r"(\d+) bytes spill stores", line).group(1))
    return rows


def ffn_sass_phase(report) -> dict:
    """The tensor-core kernels as compiled: HGMMA (wgmma) and HMMA counts in
    cuobjdump's SASS of the built libraries, and ptxas's spill bytes and
    serialised-wgmma warnings (C7512). Fails unless every bf16 FFN kernel
    has HGMMA and none spills or serialises, every tensor-core lvc_stack
    kernel (C = 16, 32, 64, 128) has HMMA and spills nothing in f32 and at C
    = 32 (bf16's other spills are reported), no f32 CUDA-core lvc_stack
    kernel spills, and every split-TF32 resblock kernel (C = 8, 16, 32, 64,
    128 with x in shared memory or in L2, C = 256 in clusters of 4) and every
    split-TF32 FFN kernel has HMMA and spills nothing."""

    def key(m):
        return f"{m.group(1)}<{m.group(2)}" + (f", {m.group(3)}>" if m.group(3) else ">")

    def lvc_key(m):
        dtype = "bf16" if m.group(2).endswith("bfloat16") else "float"
        rest = ", ".join(m.groups()[2:-1])
        return f"{m.group(1)}<{dtype}, {rest}, {'true' if m.group(m.lastindex) == '1' else 'false'}>"

    def f32_key(m):
        return (f"{m.group(1)}<{m.group(2)}, {m.group(3)}"
                + (f", {'true' if m.group(4) == '1' else 'false'}>" if m.group(4) else ">"))

    rows, f32_rows = {}, {}
    for name in ("ffn_ln", "ffn_ln_train_bwd"):
        rows.update(_sass_rows(name, report, FFN_WGMMA, key))
        f32_rows.update(_sass_rows(name, report, FFN_TF32, f32_key))
    lvc_rows = _sass_rows("lvc_stack", report, LVC_MMA, lvc_key)
    lvc_cores = _sass_rows("lvc_stack", report, LVC_CORES, lvc_key)
    rb_rows = _sass_rows("resblock", report, RESBLOCK_F32, lambda m: (
        f"{m.group(1)}<{m.group(2)}, {'true' if m.group(3) == '1' else 'false'}, "
        f"{m.group(4)}>"))
    emit({"phase": "ffn_sass", "kernels": rows, "ffn_f32": f32_rows, "lvc_stack": lvc_rows,
          "lvc_stack_cuda_cores": lvc_cores, "resblock_f32": rb_rows})
    bad = {k: r for k, r in rows.items()
           if r["hgmma"] == 0 or r["spill_bytes"] or r["serialised_wgmma"]}
    bad.update({k: r for k, r in {**rb_rows, **f32_rows}.items()
                if r["hmma"] == 0 or r["spill_bytes"]})
    bad.update({k: r for k, r in lvc_rows.items()
                if r["hmma"] == 0 or (r["spill_bytes"] and ("float" in k or ", 32," in k))})
    bad.update({k: r for k, r in lvc_cores.items() if "float" in k and r["spill_bytes"]})
    if (len(rows) != 9 or len(f32_rows) != 24 or len(lvc_rows) != 16 or len(lvc_cores) != 32
            or len(rb_rows) != 11 or bad):
        raise RuntimeError(f"tensor-core kernels: {len(rows)} bf16 ffn, {len(f32_rows)} f32 "
                           f"ffn, {len(lvc_rows)} + {len(lvc_cores)} lvc_stack and "
                           f"{len(rb_rows)} f32 resblock found, off {bad}")
    return rows


# the soft-DTW kernels: soft_dtw_wave_fwd<K, P> and soft_dtw_wave_bwd<K, P>
SOFT_DTW_WAVE = re.compile(r"soft_dtw_wave_(fwd|bwd)ILi(\d+)ELi(\d+)E")


def soft_dtw_sass_phase(report) -> dict:
    """Every soft-DTW kernel the library holds (the forward and backward at
    each rows-a-thread the plan takes): fails unless ptxas reports no spill
    and the SASS holds no local-memory access."""
    rows = _sass_rows("soft_dtw", report, SOFT_DTW_WAVE,
                      lambda m: f"soft_dtw_wave_{m.group(1)}<{m.group(2)}, {m.group(3)}>")
    emit({"phase": "soft_dtw_sass", "kernels": rows})
    bad = {k: r for k, r in rows.items() if r["spill_bytes"] or r["local"]}
    if len(rows) != 8 or bad:
        raise RuntimeError(f"soft_dtw kernels: {len(rows)} found, spilling or local {bad}")
    return rows


# this slice's kernels: ffn_wide_kernel<T, C> and the flash kernels at head
# dim 256 (the tensor-core routes' templates) and past it (the CUDA cores')
FFN_WIDE = re.compile(r"(ffn_wide_kernel)I(f|13__nv_bfloat16)Li(\d+)E")
FLASH_D = re.compile(r"((?:fwd|dq|dkv)(?:_sm90)?_kernel)ILi(\d+)E")
FLASH_WIDE = re.compile(r"(wide_(?:fwd|dq|dkv)_kernel)I(f|13__nv_bfloat16)E")


def wide_sass_phase(report) -> dict:
    """The wide kernels as compiled, reported beside the checks above:
    ``ffn_wide_kernel`` at C = 384, 512, 640 (bf16 must hold HGMMA, f32
    HMMA and no spill byte), both flash routes at head dims 128 and 256
    (HGMMA in bf16, HMMA in f32 required) and the CUDA-core flash route;
    the other spills and serialised wgmma are reported (PERF.md), not
    refused."""
    def dt(x):
        return "bf16" if x.endswith("bfloat16") else "f32"

    rows = {"ffn_wide": _sass_rows("ffn_ln", report, FFN_WIDE,
                                   lambda m: f"{m.group(1)}<{dt(m.group(2))}, {m.group(3)}>"),
            "flash_sm90": _sass_rows("flash_attention_sm90", report, FLASH_D,
                                     lambda m: f"{m.group(1)}<{m.group(2)}>"),
            "flash_f32": _sass_rows("flash_attention", report, FLASH_D,
                                    lambda m: f"{m.group(1)}<{m.group(2)}>"),
            "flash_wide": _sass_rows("flash_attention_wide", report, FLASH_WIDE,
                                     lambda m: f"{m.group(1)}<{dt(m.group(2))}>")}
    emit({"phase": "wide_sass", **rows})
    bad = {k: r for k, r in rows["ffn_wide"].items()
           if (r["hgmma"] == 0 if "bf16" in k else r["hmma"] == 0 or r["spill_bytes"])}
    bad.update({k: r for k, r in rows["flash_f32"].items() if r["hmma"] == 0})
    bad.update({k: r for k, r in rows["flash_sm90"].items() if r["hgmma"] == 0})
    if (len(rows["ffn_wide"]) != 6 or len(rows["flash_sm90"]) != 6
            or len(rows["flash_f32"]) != 6 or len(rows["flash_wide"]) != 6 or bad):
        raise RuntimeError(f"this slice's kernels: {[len(r) for r in rows.values()]} found "
                           f"(want 6 each), without tensor-core instructions {bad}")
    return rows


# csrc/gemm_mma.cuh's product, by dtype and epilogue (csrc/ffn_wide.cu's
# five, csrc/resblock.cu's wide route's two, csrc/lvc_stack.cu's wide
# route's conv), and csrc/ffn_wide.cu's row and depthwise kernels
GEMM_KERNEL = re.compile(r"gemm_kernelI(f|13__nv_bfloat16)Lb[01]ELb[01]E.*?"
                         r"(UpEp|DownEp|DupEp|StoreEpILb([01])E|ConvFirstEp|ConvSecondEp|ConvEp)")
CHAIN_ROWS = re.compile(r"\d(wide_[a-z0-9_]+?_kernel)I(f|13__nv_bfloat16)E")
# csrc/lvc_stack.cu's wide route's LVC: lvc_wide_kernel<T, Padé gate,
# 16-byte kernel loads>
LVC_WIDE = re.compile(r"(lvc_wide_kernel)I(f|13__nv_bfloat16)Lb([01])ELb([01])E")


def chain_sass_phase(report) -> dict:
    """The kernels past C = 256 as compiled: every product must hold HMMA
    (bf16 mma.sync, or f32 as split TF32), and in f32 the products and the
    chain's other kernels (the row kernels, those past C = 768 among them,
    and the depthwise ones) must spill nothing; bf16's spills are
    reported. The same for lvc_stack's wide route (C > 128): its conv
    product and its eight LVC kernels must hold HMMA, and its f32 ones
    spill nothing."""
    def dt(x):
        return "bf16" if x.endswith("bfloat16") else "f32"

    def gemm_key(m):
        ep = m.group(2) if m.group(3) is None else ("StoreEp<add>" if m.group(3) == "1"
                                                    else "StoreEp<store>")
        return f"gemm_kernel<{dt(m.group(1))}, {ep}>"

    rows = {"ffn_wide_gemm": _sass_rows("ffn_wide", report, GEMM_KERNEL, gemm_key),
            "resblock_gemm": _sass_rows("resblock", report, GEMM_KERNEL, gemm_key),
            "ffn_wide_rows": _sass_rows("ffn_wide", report, CHAIN_ROWS,
                                        lambda m: f"{m.group(1)}<{dt(m.group(2))}>"),
            "lvc_wide_gemm": _sass_rows("lvc_stack", report, GEMM_KERNEL, gemm_key),
            "lvc_wide": _sass_rows("lvc_stack", report, LVC_WIDE, lambda m: (
                f"{m.group(1)}<{dt(m.group(2))}, {'true' if m.group(3) == '1' else 'false'}, "
                f"{'true' if m.group(4) == '1' else 'false'}>"))}
    emit({"phase": "chain_sass", **rows})
    bad = {k: r for part in ("ffn_wide_gemm", "resblock_gemm", "lvc_wide_gemm", "lvc_wide")
           for k, r in rows[part].items() if r["hmma"] == 0 or ("f32" in k and r["spill_bytes"])}
    bad.update({k: r for k, r in rows["ffn_wide_rows"].items() if "f32" in k and r["spill_bytes"]})
    found = tuple(len(r) for r in rows.values())
    if found != (10, 4, 20, 2, 8) or bad:
        raise RuntimeError(f"kernels past C = 256: {found} found (want 10, 4, 20, 2, 8), "
                           f"off {bad}")
    return rows


HOST_LAUNCHES = 10_000


def host_us(fn, n: int = HOST_LAUNCHES) -> float:
    """Host-clock µs per call of ``fn`` over ``n`` calls with no
    synchronise between them, then one."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def _old_probe_path():
    """The probe's launch path as every wrapper ran it before
    ``kernels/launch.py``: a set of devices, ``get_device_capability`` on
    every launch, a contiguity pass, and a ``torch.cuda.Stream`` object for
    the stream handle; the same library and kernel."""
    from lightningfastspeech2_tpu_torch.kernels import build
    from lightningfastspeech2_tpu_torch.ops import probe as probe_mod

    lib, fn = probe_mod._fn()

    def old_probe(x):
        devs = {x.device}
        if len(devs) != 1:
            raise ValueError(f"kernel inputs span devices {devs}")
        dev = next(iter(devs))
        if dev.type != "cuda":
            raise RuntimeError(f"kernel launch needs a CUDA tensor, got {dev}")
        cap = torch.cuda.get_device_capability(dev)
        if tuple(cap) != (9, 0):
            raise RuntimeError(f"capability {cap}")
        if not x.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if x.dtype != torch.float32:
            raise ValueError(f"probe takes float32, got {x.dtype}")
        y = torch.empty_like(x)
        rc = fn(x.data_ptr(), y.data_ptr(), x.numel(),
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, rc, "probe")
        return y

    return old_probe, lib, fn


def probe_phase(dev) -> dict:
    from lightningfastspeech2_tpu_torch.kernels.launch import kernel_stream
    from lightningfastspeech2_tpu_torch.ops.probe import probe, probe_plain

    x = torch.randn(8, 128, device=dev)
    err = (probe(x) - probe_plain(x)).abs().max().item()
    old_probe, lib, fn = _old_probe_path()
    old_err = (old_probe(x) - probe_plain(x)).abs().max().item()
    torch.cuda.synchronize()
    # the old launch path and the new one in turns (old, new, new, old,
    # twice), HOST_LAUNCHES launches each, on the host clock; then where a
    # launch's host time goes, each piece alone
    turns = {"old_path": [], "new_path": []}
    for which in ("old_path", "new_path", "new_path", "old_path") * 2:
        call = old_probe if which == "old_path" else probe
        turns[which].append(host_us(lambda: call(x)))
    y = torch.empty_like(x)
    stream = kernel_stream(x)
    host = {k: statistics.median(v) for k, v in turns.items()}
    host.update({
        "torch_mul": host_us(lambda: torch.mul(x, 2.0)),
        "kernel_stream": host_us(lambda: kernel_stream(x)),
        "empty_like": host_us(lambda: torch.empty_like(x)),
        "ctypes_launch": host_us(lambda: fn(x.data_ptr(), y.data_ptr(), x.numel(), stream)),
        "old_capability_check": host_us(lambda: torch.cuda.get_device_capability(x.device)),
        "old_current_stream": host_us(lambda: torch.cuda.current_stream(x.device).cuda_stream)})
    row = {"name": "probe", "route": "cuda",
           "source": "lightningfastspeech2_tpu_torch/csrc/probe.cu",
           "replaces": "lightningfastspeech2_tpu/ops/kernel_gate.py:79",
           "at": "(8, 128) f32", "max_abs_err": max(err, old_err), "tol": 0.0,
           "ms": cuda_ms(lambda: probe(x)), "plain_ms": cuda_ms(lambda: probe_plain(x)),
           "library_ms": cuda_ms(lambda: torch.mul(x, 2.0)),
           "old_path_ms": cuda_ms(lambda: old_probe(x)),
           "host_us_per_launch": host, "host_us_turns": turns,
           "host_launches": HOST_LAUNCHES}
    row["vs_library"] = row["ms"] / row["library_ms"]
    row["bound_ms"], row["bound_by"] = bound_ms(x.numel(), 2 * tensor_bytes(x), torch.float32)
    emit({"phase": "probe", **row})
    if err != 0.0 or old_err != 0.0:
        raise RuntimeError(f"probe: max |err| {err} (old path {old_err})")
    return row


def _ffn_case(dev, B, T, k, dtype, g, C=256, F=1024) -> dict:
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import init_weights
    from lightningfastspeech2_tpu_torch.models.layers import FFTBlock
    from lightningfastspeech2_tpu_torch.ops import ffn as ffn_mod
    from lightningfastspeech2_tpu_torch.ops.ffn import ffn_ln, ffn_ln_plain

    block = FFTBlock(C, 2, k, F, dtype)
    init_weights(block, g)
    with torch.no_grad():  # non-trivial LayerNorm parameters
        for n in (block.norm1, block.norm2):
            n.weight.copy_(1.0 + 0.1 * torch.randn(C, generator=g))
            n.bias.copy_(0.1 * torch.randn(C, generator=g))
    block.to(dev)
    w = block.ffn_weights
    z = torch.randn(B, T, C, generator=g).to(dev, dtype)
    out, ref = ffn_ln(z, w), ffn_ln_plain(z, w)
    torch.cuda.synchronize()
    err, tol = max_err_and_tol(out, ref, 2e-4)
    flops = B * T * (2 * k * C + 4 * C * F)
    nbytes = 2 * tensor_bytes(z) + tensor_bytes(w.wd, w.w1, w.b1, w.w2f, w.lnp)
    row = {"at": f"z ({B}, {T}, {C}) {str(dtype)[6:]}, F={F}, k={k}",
           "max_abs_err": err, "tol": tol,
           "ms": cuda_ms(lambda: ffn_ln(z, w)), "plain_ms": cuda_ms(lambda: ffn_ln_plain(z, w))}
    row["launch"] = ffn_launches(ffn_mod, C, F, k, B, T, dtype, "serve")
    # f32 products are f32-accurate ones (split TF32), the CUDA cores' bound beside
    f32 = dtype == torch.float32
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, dtype,
                                                PEAK_F32_ACCURATE if f32 else None)
    if f32:
        row["bound_ms_cuda_cores"] = bound_ms(flops, nbytes, dtype)[0]
    emit({"phase": "kernel", "name": "ffn_ln", **row})
    if not err <= tol:
        raise RuntimeError(f"ffn_ln at {row['at']}: max |err| {err} > {tol}")
    return row


def resblock_chain_bf16(x: torch.Tensor, blocks) -> torch.Tensor:
    """The resblock chain as bf16 ``F.conv1d`` calls (cuDNN) on (B, C, L),
    ``blocks`` the resblocks' pairs with bf16 weights: a chain of library
    calls, timed beside the kernel as a yardstick; no single PyTorch call
    computes a ResBlock1."""
    import torch.nn.functional as F

    h = x.transpose(1, 2)
    out = None
    for pairs in blocks:
        y = h
        for w1, b1, d, w2, b2 in pairs:
            t = F.leaky_relu(y, 0.1)
            t = F.conv1d(t, w1, b1, padding=d * (w1.shape[-1] - 1) // 2, dilation=d)
            t = F.conv1d(F.leaky_relu(t, 0.1), w2, b2, padding=(w2.shape[-1] - 1) // 2)
            y = y + t
        out = y if out is None else out + y
    out = out / float(len(blocks)) if len(blocks) > 1 else out
    return out.transpose(1, 2)


def _resblock_cases(dev, t_mel, g, dtype=torch.bfloat16, cfg=None, stages=None,
                    singles=False) -> list:
    """Stage 0 (three resblock launches) and stages 1-3 (one trio launch
    each) of HiFi-GAN V1 (or ``cfg``; only ``stages`` where given) in
    ``dtype`` for a mel of ``t_mel`` frames, with the tile plan of each
    launch; bf16 also times the same chain through bf16 cuDNN convs.
    ``singles``: a trio stage's resblocks also one at a time. A stage the
    kernels run zero-padded (ROADMAP B16) gets x at the padded width with
    the padded channels 0, as the served generator hands it over; its
    bound is that of the unpadded work, and the copy a direct call at the
    stage's own width makes (``pad_copy_ms``) is timed beside it."""
    from lightningfastspeech2_tpu_torch.ops import hifigan_resblock as rb
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import Generator, HifiGanConfig

    cfg = cfg or HifiGanConfig()
    # serving weights: the kernels refuse parameters that need a gradient
    gen = Generator(cfg, dtype).requires_grad_(False)
    with torch.no_grad():  # unit-gain convs, so every stage carries signal
        for m in gen.resblocks.modules():
            if isinstance(m, torch.nn.Conv1d):
                m.weight.normal_(0.0, (m.in_channels * m.kernel_size[0]) ** -0.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    gen.prepare()
    gen.to(dev)
    rows, L = [], t_mel
    name = str(dtype)[6:]
    for stage, weights in enumerate(gen.stage_weights):
        L *= cfg.upsample_rates[stage]
        if stages is not None and stage not in stages:
            continue
        C = cfg.upsample_initial_channel // 2 ** (stage + 1)
        P = weights[0].channels
        x_real = torch.randn(1, L, C, generator=g).to(dev, dtype)
        x = torch.nn.functional.pad(x_real, (0, P - C))
        if singles and weights[0].n_res > 1:
            weights = weights + [rb.prepare_resblock_weights([blk], dtype) for blk in (
                gen.resblocks[stage * weights[0].n_res + j].spec()
                for j in range(weights[0].n_res))]
        for w in weights:
            trio = w.n_res > 1
            kern, plain = ((rb.resblock_trio, rb.resblock_trio_plain) if trio
                           else (rb.resblock, rb.resblock_plain))
            out = kern(x, w)
            launched = rb.last_launch()   # as the library gave it to the card
            ref = plain(x, w)
            torch.cuda.synchronize()
            err, tol = max_err_and_tol(out, ref, 1e-4)
            flops = L * sum(2 * k * C * C * 2 * len(ds)
                            for k, ds in zip(w.kernel_sizes, w.dilations))
            # x read and the output written once, each conv's weights once
            # (the f32 route's prepared taps are split: twice the weights),
            # all at the stage's own width
            n_w = sum(k * C * C * 2 * len(ds) for k, ds in zip(w.kernel_sizes, w.dilations))
            nbytes = (2 * tensor_bytes(x_real) + n_w * x.element_size()
                      + tensor_bytes(w.bias) * C // P)
            plan = rb.tile_plan(w, 1, L)
            if launched != {"blocks": plan.blocks, "tile": plan.tile,
                            "smem_bytes": plan.smem_bytes}:
                raise RuntimeError(f"{kern.__name__} at L={L}: launched {launched}, "
                                   f"planned {plan}")
            at = f"x (1, {L}, {C}) {name}, k={list(w.kernel_sizes)}, Tmel={t_mel}"
            row = {"name": kern.__name__, "stage": stage, "channels": C,
                   "at": at if P == C else f"{at}, run at C={P}",
                   "route": plan.route, "max_abs_err": err, "tol": tol,
                   "ms": cuda_ms(lambda: kern(x, w)), "plain_ms": cuda_ms(lambda: plain(x, w)),
                   "plain": ("the f32 cuDNN chain (F.conv1d, TF32 off)" if dtype == torch.float32
                             else "f32 cuDNN convs on bf16-rounded values"),
                   "tile": launched["tile"], "blocks_per_launch": launched["blocks"],
                   "smem_bytes": launched["smem_bytes"], "x_in_smem": plan.x_in_smem,
                   "halo_recompute_share": plan.halo_share}
            if P != C:
                row["kernel_channels"] = P
                row["pad_copy_ms"] = cuda_ms(lambda: torch.nn.functional.pad(x_real, (0, P - C)))
                row["direct_call_ms"] = cuda_ms(lambda: kern(x_real, w))
                if torch.count_nonzero(out[..., C:]).item():
                    raise RuntimeError(f"{kern.__name__} at {at}: padded channels not 0")
            if dtype == torch.bfloat16:
                blocks = [[(w1.to(dtype), b1.to(dtype), d, w2.to(dtype), b2.to(dtype))
                           for w1, b1, d, w2, b2 in pairs] for pairs in w.pairs]
                chain = resblock_chain_bf16(x, blocks)
                row["cudnn_bf16_chain_ms"] = cuda_ms(lambda: resblock_chain_bf16(x, blocks))
                row["cudnn_bf16_chain_max_abs_err"] = (chain.float() - ref.float()).abs().max().item()
            # f32 products at f32 accuracy: split TF32 (165 TFLOP/s), the
            # CUDA cores' 67 beside it
            row["bound_ms"], row["bound_by"] = bound_ms(
                flops, nbytes, dtype, PEAK_F32_ACCURATE if dtype == torch.float32 else None)
            if dtype == torch.float32:
                row["bound_ms_cuda_cores"] = bound_ms(flops, nbytes, dtype)[0]
            row["tflops"] = flops / row["ms"] / 1e9
            row["x_bound"] = row["ms"] / row["bound_ms"]
            emit({"phase": "kernel", **row})
            if not err <= tol:
                raise RuntimeError(f"{row['name']} at {row['at']}: max |err| {err} > {tol}")
            rows.append(row)
    return rows


def kernels_phase(dev) -> dict:
    g = torch.Generator().manual_seed(0)
    # the served batch's decoder shape first (bucket 512), then the
    # 2048-frame decoder in both types and the encoder's widest kernel
    ffn = [_ffn_case(dev, 8, 512, 17, torch.bfloat16, g),
           _ffn_case(dev, 8, 2048, 17, torch.float32, g),
           _ffn_case(dev, 8, 2048, 17, torch.bfloat16, g),
           _ffn_case(dev, 8, 256, 25, torch.bfloat16, g)]
    rbs = _resblock_cases(dev, 512, g)
    # the f32 route (split TF32) at the same shapes: phase 6's request and
    # phase 5's f32 vocoder call take it
    rbs_f32 = _resblock_cases(dev, 512, g, torch.float32)
    return {"ffn_ln": ffn, "resblock": [r for r in rbs if r["name"] == "resblock"],
            "resblock_trio": [r for r in rbs if r["name"] == "resblock_trio"],
            "resblock_f32": rbs_f32}


def _calibrate_durations(model, gen, texts) -> float:
    """Bias the untrained duration head so rounded durations average about
    FRAMES_PER_PHONE (an untrained head gives ~1 frame per phone); returns
    the bias."""
    from lightningfastspeech2_tpu_torch.core.bucketing import pad_to

    ids = [gen.text_to_ids(t) for t in texts]
    P = gen.bucketer.phone_bucket(max(len(i) for i in ids))
    phones = torch.as_tensor(np.stack([pad_to(i, P) for i in ids]), device=model.device)
    speakers = torch.as_tensor(np.stack([gen.speaker2dvector["spk0"]] * len(ids)),
                               device=model.device)
    head = model.variance_adaptor.duration_predictor.linear
    with torch.no_grad():
        head.bias.zero_()
        out = model({"phones": phones, "speaker": speakers}, inference=True,
                    duration_only=True)
        pred = out["duration_prediction"].float()[out["phone_mask"]]
        bias = math.log(FRAMES_PER_PHONE + 1.0) - math.log(pred.exp().mean().item())
        head.bias.fill_(bias)
    return bias


def _make_generator(cfg, dtype, dev, dvecs, texts, bias, fastdiff=False, noise_source=None,
                    hifigan_cfg=None):
    """The served generator: the flagship and HiFi-GAN V1 (or
    ``hifigan_cfg``), or with ``fastdiff`` the flagship with its residual
    head and the FastDiff vocoder (its noise from ``noise_source`` where
    given)."""
    from lightningfastspeech2_tpu_torch.data.vocab import Vocab
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.synthesis.g2p import BUILTIN_LEXICON, EnglishG2P
    from lightningfastspeech2_tpu_torch.synthesis.generator import (
        FastDiffSynthesiser,
        SpeechGenerator,
    )
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import HifiGanConfig, Synthesiser

    g2p = EnglishG2P(BUILTIN_LEXICON)  # the generate CLI's default lexicon
    vocab = Vocab(p for t in texts for p in g2p(t))
    model = build_fastspeech2(cfg.model, dtype=dtype, device=dev, seed=0,
                              use_fastdiff_head=fastdiff)
    if fastdiff:
        synth = FastDiffSynthesiser(cfg.model, vocoder_precision=16 if dtype == torch.bfloat16
                                    else 32, device=dev, seed=1, noise_source=noise_source)
    else:
        synth = Synthesiser(hifigan_cfg or HifiGanConfig(), dtype=dtype, device=dev, seed=1)
    gen = SpeechGenerator(cfg, model, vocab, g2p, synthesiser=synth,
                          speaker2dvector=dvecs)
    if bias is None:
        bias = _calibrate_durations(model, gen, texts)
    else:
        with torch.no_grad():
            model.variance_adaptor.duration_predictor.linear.bias.fill_(bias)
    return gen, bias


def _serve_all(gen, cfg, dvecs, tag: str = "") -> dict:
    """A warm-up request, the sentences one by one through
    ``generate_from_text`` and one batch of 8 through ``generate_samples``
    at frame bucket 512; every waveform checked finite. Returns the
    requests, the batch's row and the frame bucket of every vocoder call."""
    from lightningfastspeech2_tpu_torch.core.bucketing import pad_to

    def serve(text, seed):
        t = time.perf_counter()
        wav = gen.generate_from_text(text, speaker="spk0", seed=seed)
        ms = (time.perf_counter() - t) * 1e3
        if not (wav.ndim == 1 and wav.size > 0 and np.isfinite(wav).all()):
            raise RuntimeError(f"bad waveform for {text!r}: {wav.shape}")
        n_ph = len(gen.text_to_ids(text))
        frames = wav.size // cfg.model.audio.hop_length
        return {"text_chars": len(text), "phones": n_ph,
                "phone_bucket": gen.bucketer.phone_bucket(n_ph), "frames": frames,
                "frame_bucket": gen.bucketer.frame_bucket(frames),
                "frames_per_phone": frames / n_ph, "ms": ms,
                "audio_s": wav.size / SAMPLING_RATE, "finite": True,
                "peak": float(np.abs(wav).max())}

    warm = serve("Warm up the card.", 0)
    emit({"phase": f"{tag}request", "cold": True, **warm})
    requests = []
    for i, text in enumerate(SENTENCES):
        r = serve(text, i)
        emit({"phase": f"{tag}request", **r})
        requests.append(r)
    if len({r["phones"] for r in requests}) != len(SENTENCES):
        raise RuntimeError("the sentences should differ in length")

    # one batch of 8 from the phones of all texts: the longest item needs
    # ~360 frames, which puts the batch in frame bucket 512 (256, 512]
    fpp = sum(r["frames"] for r in requests) / sum(r["phones"] for r in requests)
    n_max = max(8, int(360 / fpp))
    stream = np.concatenate([gen.text_to_ids(t) for t in BATCH_TEXTS])
    ids = [stream[5 * j: 5 * j + max(4, n_max - 4 * j)] for j in range(len(BATCH_TEXTS))]
    P = gen.bucketer.phone_bucket(max(len(i) for i in ids))
    batch = {"phones": np.stack([pad_to(i, P) for i in ids]),
             "speaker": np.stack([dvecs[f"spk{j % 4}"] for j in range(len(ids))])}
    t = time.perf_counter()
    wavs = gen.generate_samples(batch)
    ms = (time.perf_counter() - t) * 1e3
    frames = [w.size // cfg.model.audio.hop_length for w in wavs]
    bucket = gen.bucketer.frame_bucket(max(frames))
    finite = all(w.size > 0 and np.isfinite(w).all() for w in wavs)
    audio_s = sum(w.size for w in wavs) / SAMPLING_RATE
    row = {"phase": f"{tag}batch", "batch": len(wavs), "phone_bucket": P,
           "frame_bucket": bucket, "frames": frames, "ms": ms, "audio_s": audio_s,
           "finite": finite, "audio_s_per_s": audio_s / (ms / 1e3)}
    emit(row)
    if not finite or bucket != 512:
        raise RuntimeError(f"batch: finite={finite}, frame bucket {bucket} (want 512)")
    torch.cuda.synchronize()
    # every vocoder call (one per item) sees the mel at its request's bucket
    buckets = [warm["frame_bucket"]] + [r["frame_bucket"] for r in requests] + [bucket] * len(wavs)
    return {"requests": requests, "batch": row, "batch_inputs": batch,
            "vocoder_buckets": buckets, "n_calls": len(SENTENCES) + 2}


BATCH_RUNS = 5


def batch_repeats(gen, batch, first: dict) -> dict:
    """The served batch again, BATCH_RUNS times on the host clock, outside
    the counted run: its median and spread, since one host-clock reading
    moves by up to 2x between runs of the same code."""
    runs = []
    for _ in range(BATCH_RUNS):
        t = time.perf_counter()
        gen.generate_samples(batch)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(runs)
    row = {"phase": "batch_repeats", "batch": first["batch"],
           "frame_bucket": first["frame_bucket"], "ms_median": ms, "ms_min": min(runs),
           "ms_max": max(runs), "ms_runs": runs, "first_ms": first["ms"],
           "audio_s_per_s_median": first["audio_s"] / (ms / 1e3)}
    emit(row)
    return row


def serving_phase(counters) -> dict:
    """The main path: build the flagship and V1 in bf16 on the card, serve
    the sentences one by one and one batch of 8 at frame bucket 512."""
    from lightningfastspeech2_tpu_torch.core.config import lightspeech_flagship

    cfg = lightspeech_flagship()
    rng = np.random.default_rng(0)
    dvecs = {}
    for i in range(4):
        v = rng.standard_normal(cfg.model.dvector_dim).astype(np.float32)
        dvecs[f"spk{i}"] = v / np.linalg.norm(v)
    # set-up, not the main path: the duration bias from the same seeded
    # weights through the plain path on the CPU, so it launches no kernel
    _, bias = _make_generator(cfg, torch.float32, "cpu", dvecs, BATCH_TEXTS, None)
    reset_counts(counters)
    t0 = time.perf_counter()
    gen, _ = _make_generator(cfg, torch.bfloat16, None, dvecs, BATCH_TEXTS, bias)
    emit({"phase": "serving_setup", "seconds": time.perf_counter() - t0,
          "duration_bias": bias,
          "note": "untrained duration head biased so rounded durations average "
                  f"about {FRAMES_PER_PHONE:g} frames per phone (bias taken on "
                  "the CPU before the launch counters were set to 0)"})
    run = _serve_all(gen, cfg, dvecs)
    launches = {c.__name__: c.launches for c in counters}
    head_dims = flash_head_dims(counters)
    # what the path must launch: the probe once, when the first entry point
    # resolves the card; per generate_samples call (the warm-up, each
    # sentence, the batch) the encoder's blocks in the duration pass and
    # the encoder's and decoder's in the full pass; per vocoder call (one
    # per item) one resblock or trio launch per prepared stack
    m, stacks = cfg.model, gen.synthesiser.model.stage_weights
    n_items = len(run["vocoder_buckets"])
    want = {c.__name__: 0 for c in counters}   # the training kernels: none here
    want.update({"probe": 1,
                 "ffn_ln": run["n_calls"] * (2 * m.encoder.layers + m.decoder.layers),
                 "resblock": n_items * sum(len(s) for s in stacks if len(s) > 1),
                 "resblock_trio": n_items * sum(1 for s in stacks if len(s) == 1)})
    emit({"phase": "launches", **launches, "expected": want})
    path = ("probe", "ffn_ln", "resblock", "resblock_trio")
    if launches != want or any(launches[k] == 0 for k in path):
        raise RuntimeError(f"serving-path launches {launches}, expected {want}")
    repeats = batch_repeats(gen, run["batch_inputs"], run["batch"])
    profile_row = hifigan_vocoder_profile(gen.synthesiser, cfg)
    # the same call in f32, the generate CLI's default --vocoder_precision 32
    # (its split-TF32 resblock route), from the same seed
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import HifiGanConfig, Synthesiser

    profile_f32 = hifigan_vocoder_profile(
        Synthesiser(HifiGanConfig(), dtype=torch.float32, seed=1), cfg, "_f32")
    return {"vocoder_profile": profile_row, "vocoder_profile_f32": profile_f32,
            "batch_repeats": repeats, "flash_head_dims": head_dims,
            "launches": launches, "bias": bias, "dvecs": dvecs, "cfg": cfg,
            "requests": run["requests"], "batch": run["batch"]}


HIFIGAN_PROFILE_FRAMES = 512
HIFIGAN_CALL_RUNS = 5


def hifigan_vocoder_profile(synth, cfg, tag: str = "") -> dict:
    """One HiFi-GAN vocoder call on a 512-frame mel, outside the counted
    run: the host clock over HIFIGAN_CALL_RUNS calls (the median), then
    one call under the profiler for device ms and the resblock kernels'
    ms, share and launches (the kernel table in
    hifigan_vocoder_profile{tag}.txt)."""
    from torch.profiler import ProfilerActivity, profile

    mel = (np.random.default_rng(5).standard_normal(
        (HIFIGAN_PROFILE_FRAMES, cfg.model.audio.n_mels)) - 4.0).astype(np.float32)
    synth(mel)
    torch.cuda.synchronize()
    runs = []
    for _ in range(HIFIGAN_CALL_RUNS):
        t = time.perf_counter()
        synth(mel)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        synth(mel)
        torch.cuda.synchronize()
    split = _step_split(prof, f"hifigan_vocoder_profile{tag}.txt")
    row = {"phase": f"hifigan_vocoder_profile{tag}", "frames": HIFIGAN_PROFILE_FRAMES,
           "dtype": str(synth.model.dtype)[6:],
           "call_ms": statistics.median(runs), "call_ms_runs": runs,
           "device_ms": split["device_ms"], "device_launches": split["device_launches"],
           "resblock_ms": split["resblock_ms"], "resblock_launches": split["resblock_launches"],
           "resblock_share": split["resblock_ms"] / max(split["device_ms"], 1e-9),
           "rest_device_ms": split["device_ms"] - split["resblock_ms"]}
    emit(row)
    if split["resblock_launches"] != 6:
        raise RuntimeError(f"profiled {row['dtype']} vocoder call: "
                           f"{split['resblock_launches']} resblock kernel launches on the "
                           "device, expected 6")
    return row


def reference_phase(served, fastdiff: bool = False, tag: str = "", hifigan_cfg=None) -> dict:
    """One f32 request on the card (kernels) against the same request on
    the CPU (plain versions), same seeded weights and duration bias; with
    ``fastdiff``, the FastDiff server, its noise drawn on the CPU from one
    seed for each call and handed to both; ``hifigan_cfg`` another
    HiFi-GAN than V1."""
    text = SENTENCES[1]
    cfg = served["fastdiff_cfg"] if fastdiff else served["cfg"]

    def cpu_noise(shape, N):
        g = torch.Generator().manual_seed(7)
        return torch.randn(tuple(shape), generator=g), torch.randn((N, *shape), generator=g)

    from lightningfastspeech2_tpu_torch.ops.ffn import ffn_ln

    wavs, ms = {}, {}
    for dev in ("cuda", "cpu"):
        gen, _ = _make_generator(cfg, torch.float32, dev, served["dvecs"], BATCH_TEXTS,
                                 bias=served["bias"], fastdiff=fastdiff,
                                 noise_source=cpu_noise if fastdiff else None,
                                 hifigan_cfg=hifigan_cfg)
        reset_counts((ffn_ln,))
        t = time.perf_counter()
        wavs[dev] = gen.generate_from_text(text, speaker="spk1", seed=0)
        ms[dev] = (time.perf_counter() - t) * 1e3
        if dev == "cuda":
            n_ffn = ffn_ln.launches  # the request's f32 serving FFN launches
    a, b = wavs["cuda"], wavs["cpu"]
    top = float(np.abs(b).max())
    err = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
    # f32 on both sides, TF32 off: summation order only, through two models
    # (and, for FastDiff, four ε passes of the reverse sampler)
    tol = 1e-3 * top + 1e-7
    name = tag + ("fastdiff_reference" if fastdiff else "reference")
    row = {"phase": name, "samples": [a.size, b.size], "max_abs_err": err,
           "tol": tol, "peak": top, "request_ms": ms, "ffn_ln_launches": n_ffn}
    emit(row)
    if not (a.shape == b.shape and err <= tol and top > 0):
        raise RuntimeError(f"{name} card vs CPU: shapes {a.shape} {b.shape}, "
                           f"max |err| {err} > {tol}")
    return row


# ---------------------------------------------------------- training slice
TRAIN_B, TRAIN_P, TRAIN_T = 8, 256, 2048   # bench.py's training workload
STEP_PAIRS = 8


def train_config(rates: bool = True, B_P_T=(TRAIN_B, TRAIN_P, TRAIN_T), mel_loss: str = "l1"):
    """The flagship cut to one frame bucket (max_phones P, max_frames T), its
    config dropout rates or (``rates=False``) every rate 0, and the mel
    loss (the flagship's l1, or soft_dtw)."""
    from lightningfastspeech2_tpu_torch.core.config import lightspeech_flagship, replace

    _, P, T = B_P_T
    cfg = lightspeech_flagship()
    cfg = replace(cfg, train=replace(cfg.train, mel_loss=mel_loss))
    m = replace(cfg.model, max_phones=P, max_frames=T)
    if not rates:
        m = replace(m, encoder=replace(m.encoder, dropout=0.0),
                    decoder=replace(m.decoder, dropout=0.0),
                    variance=replace(m.variance, dropouts=(0.0,) * len(m.variance.variances)),
                    duration=replace(m.duration, dropout=0.0))
    return replace(cfg, model=m)


def train_batch(cfg, B_P_T=(TRAIN_B, TRAIN_P, TRAIN_T)):
    """bench.py's batch: P - 16 valid phones whose teacher durations fill T."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import make_dummy_batch

    B, P, T = B_P_T
    return make_dummy_batch(cfg.model, batch_size=B, n_phones=P - 16, n_frames=T,
                            seed=0, fill_frames=True)


def cuda_ms_grad(out, inputs, grad, **kw) -> float:
    """Time of the backward alone: autograd.grad on a retained graph."""
    return cuda_ms(lambda: torch.autograd.grad(out, inputs, grad, retain_graph=True), **kw)


def ffn_launches(ffn, C, F, k, B, T, dtype, mode) -> list:
    """The launches of the latest ``mode`` call (serve, train, bwd) as the
    libraries recorded them, held against ``ffn_plan``: raises when a
    grid, shared-memory size or row count differs."""
    rec = ffn.last_launches()
    plan = ffn.ffn_plan(C, F, k, B, T, dtype, mode)
    wide = plan[0].kernel == "ffn_wide_kernel"
    if plan[0].kernel.startswith("wide_ln1"):   # csrc/ffn_wide.cu's chain, every launch
        got = rec["ffn_wide"]
    else:
        got = ([rec["ffn_ln"]] + (rec["ffn_ln_train_bwd"] if mode == "bwd" else [])
               + ([rec["ffn_ln_wide_ln2"]] if wide else []))
    want = [ffn.planned_launch(x) for x in plan]
    if got != want:
        raise RuntimeError(f"ffn {mode} launches {got}, planned {want}")
    rows = [{"kernel": x.kernel, "blocks": r["grid"][0] * r["grid"][1] * r["grid"][2],
             "smem_bytes": r["smem_bytes"], "rows": r["rows"], "cluster": r["cluster"]}
            for x, r in zip(plan, got)]
    if wide:  # the wide launch's splits of F and the clusters the card holds at once
        rows[0].update(splits=got[0]["grid"][2],
                       max_active_clusters=rec["ffn_ln_max_active_clusters"])
    return rows


def _b1_off_the_kink(z, p, eps=1e-5):
    """b1 with every F column that holds a ReLU input within 2^-14 of its
    products' magnitude sum of zero (C / 768 times that past C = 768) moved
    by the least multiple of 0.01 that clears the column: f32 sums of C
    products in two orders (kernel, plain version) stay within C 2^-24 of
    that sum of the exact value, so every ReLU then takes the same branch
    in both. t1, h0 and W1 are rounded to z's dtype, as both round them."""
    from lightningfastspeech2_tpu_torch.ops.depthwise import depthwise_conv1d
    from lightningfastspeech2_tpu_torch.ops.layer_norm import layer_norm_fn

    wd, bd, w1, b1, _, _, g1, be1, _, _ = (t.detach() for t in p)
    dt, C = z.dtype, z.shape[-1]
    with torch.no_grad():
        t1 = layer_norm_fn(z.float(), g1, be1, torch.float32, eps).to(dt).float()
        h0 = depthwise_conv1d(t1, wd.t().unsqueeze(1).float(), bd.float()).to(dt).double()
        w1 = w1.to(dt).double()
        exact = (h0 @ w1).reshape(-1, w1.shape[1])
        mag = (h0.abs() @ w1.abs()).reshape(-1, w1.shape[1])
    margin = 2.0 ** -14 * max(1.0, C / 768)
    moved = b1.clone()
    for step in range(1, 100):
        b = moved.double()
        bad = ((exact + b).abs() <= margin * (mag + b.abs())).any(0)
        if not bad.any():
            return moved
        moved = torch.where(bad, b1 + 0.01 * step, moved)
    raise RuntimeError("no b1 clears the ReLU kink")


def ffn_products_ms(B, T, C, F, dev, mode) -> float:
    """The FFN half's products alone as f32 ``torch.matmul`` calls (TF32
    off) on random operands of their shapes: the forward's h0 W1 and up
    W2f; the backward's six (the chain's two, dup_d, dacc, dW1, dW2f). A
    chain of library calls, a yardstick, not a port."""
    g = torch.Generator(device=dev).manual_seed(0)
    h0, dff = (torch.randn(B * T, C, device=dev, generator=g) for _ in range(2))
    up = torch.randn(B * T, F, device=dev, generator=g)
    w1 = torch.randn(C, F, device=dev, generator=g)
    w2f = torch.randn(F, C, device=dev, generator=g)
    if mode == "fwd":
        return cuda_ms(lambda: (h0 @ w1, up @ w2f))
    return cuda_ms(lambda: (h0 @ w1, up @ w2f, dff @ w2f.t(), up @ w1.t(), h0.t() @ up,
                            up.t() @ dff))


def _ffn_train_case(dev, B, T, k, g, dtype=torch.bfloat16, C=256, F=1024,
                    timed: float = 200.0, off_kink=None) -> dict:
    """ffn_ln_train forward and backward kernels at one of the step's FFN
    shapes (rate 0.1; C 256 and F 1024 unless given): the output and every
    gradient against the plain version's autograd (bf16: and the gradients'
    distance from the staged plain backward, the kernels' own rounding
    points; f32, or either with ``off_kink``: b1 moved off the ReLU kink
    first, as the card tests move it), the kernel times with
    the call's weight layouts prepared (each timing fills ``timed`` ms; 0:
    untimed), each launch as the
    library recorded it. A width no depthwise block builds (F not a
    multiple of C) draws the kernel's parameters directly. f32 adds its
    bound at the CUDA cores' 67 TFLOP/s and its products' time as f32
    ``torch.matmul`` calls."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import init_weights
    from lightningfastspeech2_tpu_torch.models.layers import FFTBlock
    from lightningfastspeech2_tpu_torch.ops import ffn

    rate = 0.1
    f32 = dtype == torch.float32
    if F % C:
        def draw(*shape, scale, shift=0.0):
            return (shift + scale * torch.randn(*shape, generator=g)).to(dev)

        p = [draw(k, C, scale=0.3), draw(C, scale=0.1), draw(C, F, scale=C ** -0.5),
             draw(F, scale=0.1), draw(F, C, scale=F ** -0.5), draw(C, scale=0.1),
             draw(C, scale=0.1, shift=1.0), draw(C, scale=0.1), draw(C, scale=0.1, shift=1.0),
             draw(C, scale=0.1)]
        p = [t.requires_grad_(True) for t in p]
    else:
        block = FFTBlock(C, 2, k, F, dtype)
        init_weights(block, g)
        with torch.no_grad():
            for n in (block.norm1, block.norm2):
                n.weight.copy_(1.0 + 0.1 * torch.randn(C, generator=g))
                n.bias.copy_(0.1 * torch.randn(C, generator=g))
        block.to(dev)
        p = [t.detach().clone().requires_grad_(True)
             for t in ffn.ffn_train_params(*block._ffn_modules())]
    z = torch.randn(B, T, C, generator=g).to(dev, dtype)
    dout = torch.randn(B, T, C, generator=g).to(dev, dtype)
    if f32 if off_kink is None else off_kink:
        p[3] = _b1_off_the_kink(z, p).requires_grad_(True)
    seed = torch.tensor([4242], dtype=torch.int32, device=dev)
    at = f"z ({B}, {T}, {C}) {str(dtype)[6:]}, F={F}, k={k}, rate={rate}"
    w = ffn._kernel_layouts(p, dtype)
    def timer(fn):
        return cuda_ms(fn, min_total_ms=timed) if timed else (fn(), None)[1]

    row_f = {"name": "ffn_ln_train", "at": at,
             "ms": timer(lambda: ffn.ffn_ln_train_fwd(z, p, seed, rate, layouts=w))}
    row_f["launch"] = ffn_launches(ffn, C, F, k, B, T, dtype, "train")
    row_b = {"name": "ffn_ln_train_bwd", "at": at,
             "ms": timer(lambda: ffn.ffn_ln_train_bwd(dout, z, p, seed, rate, layouts=w))}
    row_b["launch"] = ffn_launches(ffn, C, F, k, B, T, dtype, "bwd")
    # what a training call adds to the kernels: the weight layouts it prepares
    row_f["layouts_ms"] = timer(lambda: ffn._kernel_layouts(p, dtype))
    wbytes = sum(tensor_bytes(t) for t in p)
    # the backward recomputes up and ff (4CF) and forms dup, dacc, dW1, dW2f
    # (8CF); f32 products are f32-accurate ones (PEAK_F32_ACCURATE, split
    # TF32), with the CUDA cores' bound beside them
    work = {"fwd": (B * T * (2 * k * C + 4 * C * F), 2 * tensor_bytes(z) + wbytes),
            "bwd": (B * T * (6 * k * C + 12 * C * F), 3 * tensor_bytes(z) + 2 * wbytes)}
    for r, part in ((row_f, "fwd"), (row_b, "bwd")):
        r["bound_ms"], r["bound_by"] = bound_ms(*work[part], dtype,
                                                PEAK_F32_ACCURATE if f32 else None)
        if f32:
            r["bound_ms_cuda_cores"] = bound_ms(*work[part], dtype)[0]
            r["products_matmul_ms"] = ffn_products_ms(B, T, C, F, dev, part) if timed else None
    zk = z.clone().requires_grad_(True)
    out = ffn.ffn_ln_train(zk, p, seed, rate)
    grads = torch.autograd.grad(out, [zk, *p], dout)
    zp = z.clone().requires_grad_(True)
    ref = ffn.ffn_ln_train_plain(zp, p, seed, rate)
    ref_grads = torch.autograd.grad(ref, [zp, *p], dout, retain_graph=True)
    staged = ffn.ffn_ln_train_bwd_plain(dout, z, p, seed, rate)
    torch.cuda.synchronize()
    err, tol = max_err_and_tol(out, ref, 2e-4)
    row_f.update(max_abs_err=err, tol=tol,
                 plain_ms=timer(lambda: ffn.ffn_ln_train_plain(z, p, seed, rate)))
    # gradients against the plain version's autograd: bf16, the kernel
    # rounds dff and dup to bf16 before its products, the plain version
    # keeps them f32, each within 3 % of its largest element; f32, the
    # summation order only, each within 2e-4 of its largest element and
    # its mean error within 2e-5
    errs, staged_rel = {}, {}
    names = ("dz", "dwd", "dbd", "dw1", "db1", "dw2f", "db2f", "dg1", "dbe1", "dg2", "dbe2")
    for name, a, b, c in zip(names, grads, ref_grads, staged):
        d = (a.float() - b.float()).abs()
        top = b.float().abs().max().item()
        errs[name] = ((d.max().item(), 2e-4 * top + 1e-6, d.mean().item(), 2e-5 * top + 1e-7)
                      if f32 else (d.max().item(), 0.03 * top))
        staged_rel[name] = ((a.float() - c.float()).abs().max()
                            / c.float().abs().max().clamp_min(1e-30)).item()
    row_b.update(max_abs_err=max(e[0] for e in errs.values()),
                 grad_errs=errs,
                 tol=("2e-4 of each gradient's largest element, the mean 2e-5" if f32
                      else "3 % of each gradient's largest element"),
                 staged_plain_max_rel_err=staged_rel,
                 plain_ms=(cuda_ms_grad(ref, [zp, *p], dout, min_total_ms=timed) if timed
                           else None))
    for r in (row_f, row_b):
        emit({"phase": "kernel", **r})
    if not err <= tol:
        raise RuntimeError(f"ffn_ln_train at {at}: max |err| {err} > {tol}")
    bad = {n: e for n, e in errs.items()
           if not (e[0] <= e[1] and (len(e) == 2 or e[2] <= e[3]))}
    if bad:
        raise RuntimeError(f"ffn_ln_train_bwd at {at}: gradients off {bad}")
    return {"fwd": row_f, "bwd": row_b}


def _flash_case(dev, g, dtype=torch.bfloat16, B=TRAIN_B, T=TRAIN_T, rate=0.1, H=2,
                d=128) -> dict:
    """flash_attention forward and backward against the plain version, with
    SDPA (same mask and dropout_p) timed as the library yardstick: bf16 at
    the decoder's shape (the wgmma kernels of flash_attention_sm90.cu), f32
    at phase 9's (the split-TF32 mma.sync kernels of flash_attention.cu)."""
    import torch.nn.functional as F
    from lightningfastspeech2_tpu_torch.kernels import build
    from lightningfastspeech2_tpu_torch.ops import attention as att

    q, k, v, do = (torch.randn(B, H, T, d, generator=g).to(dev, dtype) for _ in range(4))
    lengths = torch.tensor([T - 97 * i for i in range(B)], device=dev)
    mask = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    mask_i32 = mask.to(torch.int32)
    seed = torch.tensor([99], dtype=torch.int32, device=dev)
    name = str(dtype)[6:] + ("" if d == 128 else f"_d{d}")
    at = f"q/k/v ({B}, {H}, {T}, {d}) {name}, ragged key mask, rate={rate}"
    route = att.kernel_route(q, k, v)
    fns = (att.flash_attention, att.flash_attention_bwd)
    before = [dict(fn.by_route) for fn in fns]
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = att.flash_attention(*qkv, mask, rate, seed)
    grads = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    routed = [{r: fn.by_route[r] - n for r, n in b.items()} for fn, b in zip(fns, before)]
    pq = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = att.flash_attention_plain(*pq, mask, rate, seed)
    ref_grads = torch.autograd.grad(ref, pq, do, retain_graph=True)
    torch.cuda.synchronize()
    # bf16 in and out; the kernel rounds p against the running max, the
    # plain version the normalised p: 2 % of the largest element; f32:
    # summation order only, 1e-4 of the largest element
    frac = 0.02 if dtype == torch.bfloat16 else 1e-4
    errs = {n: ((a.float() - b.float()).abs().max().item(), frac * b.float().abs().max().item())
            for n, a, b in zip(("o", "dq", "dk", "dv"), (out, *grads), (ref, *ref_grads))}
    o, lse, o32 = att.flash_attention_fwd(q, k, v, mask_i32, seed, rate)
    suffix = ("" if dtype == torch.bfloat16 else "_f32") + ("" if d == 128 else f"_d{d}")
    common = {"at": at, "route": route, "build_s": build.build_report[att.LIBRARY[route]]["seconds"],
              "head_dim": d}
    row_f = {"name": "flash_attention" + suffix, **common, "max_abs_err": errs["o"][0],
             "tol": errs["o"][1],
             "ms": cuda_ms(lambda: att.flash_attention_fwd(q, k, v, mask_i32, seed, rate)),
             "plain_ms": cuda_ms(lambda: att.flash_attention_plain(q, k, v, mask, rate, seed))}
    row_b = {"name": "flash_attention_bwd" + suffix, **common,
             "max_abs_err": max(errs[n][0] for n in ("dq", "dk", "dv")), "grad_errs": errs,
             "tol": f"{frac:g} of each gradient's largest element",
             "ms": cuda_ms(lambda: att.flash_attention_bwd(do, q, k, v, mask_i32, seed, o32, lse,
                                                           rate)),
             "plain_ms": cuda_ms_grad(ref, pq, do)}
    if rate > 0.0:
        # the same kernels without dropout: what the keep hash costs
        _, lse0, o320 = att.flash_attention_fwd(q, k, v, mask_i32, seed, 0.0)
        row_f["ms_rate0"] = cuda_ms(lambda: att.flash_attention_fwd(q, k, v, mask_i32, seed, 0.0))
        row_b["ms_rate0"] = cuda_ms(lambda: att.flash_attention_bwd(do, q, k, v, mask_i32, seed,
                                                                    o320, lse0, 0.0))
    # the library call: SDPA with the same boolean key mask and dropout_p
    am = mask[:, None, None, :]
    row_f["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=am, dropout_p=rate))
    sq = [t.clone().requires_grad_(True) for t in (q, k, v)]
    sout = F.scaled_dot_product_attention(*sq, attn_mask=am, dropout_p=rate)
    row_b["library_ms"] = cuda_ms_grad(sout, sq, do)

    def sdpa_fwd_bwd():
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        torch.autograd.grad(F.scaled_dot_product_attention(*xs, attn_mask=am, dropout_p=rate),
                            xs, do)
    row_b["library_fwd_bwd_ms"] = cuda_ms(sdpa_fwd_bwd)
    # The function's work on this mask: a T x d by d x n product per (b, h)
    # over the n valid keys of each item (all T keys where there is none).
    # Forward: S and P.V; backward: the five products S, dP, dV, dQ, dK.
    # The kernels' split backward forms S and dP in both passes, seven
    # products: its own figure is split_bound_ms. f32 products are
    # f32-accurate ones (PEAK_F32_ACCURATE).
    nb = tensor_bytes(q, k, v)
    n_keys = mask.sum(1)
    unit = H * T * d * torch.where(n_keys > 0, n_keys, T).sum().item()
    bwd_bytes = 2 * nb + tensor_bytes(do, o, lse)
    peak = PEAK_F32_ACCURATE if dtype == torch.float32 else None
    for r, ops, nbytes in ((row_f, 4 * unit, nb + tensor_bytes(o, lse)),
                           (row_b, 10 * unit, bwd_bytes)):
        r["bound_ms"], r["bound_by"] = bound_ms(ops, nbytes, dtype, peak)
        r["vs_library"] = r["ms"] / r["library_ms"]
    row_b["split_bound_ms"] = bound_ms(14 * unit, bwd_bytes, dtype, peak)[0]
    if route == "flash_attention":
        # the grids the library gave its latest launches, all at this shape
        row_f["blocks_per_launch"] = flash_f32_blocks(0)
        row_b["blocks_per_launch"] = {"dq": flash_f32_blocks(1), "dkv": flash_f32_blocks(2)}
    for r in (row_f, row_b):
        emit({"phase": "kernel", **r})
    bad = {n: e for n, e in errs.items() if not e[0] <= e[1]}
    if bad:
        raise RuntimeError(f"flash_attention at {at}: off {bad}")
    want = [{r: int(r == route) for r in b} for b in before]
    if routed != want:
        raise RuntimeError(f"flash_attention at {at}: launches by route {routed}, expected {want}")
    return {"fwd": row_f, "bwd": row_b}


def flash_f32_blocks(which: int) -> int:
    """Blocks in the grid of the f32 flash library's latest launch of
    kernel ``which`` (0 the forward, 1 the dQ pass, 2 the dK/dV pass), as
    the library recorded it when the launch was accepted."""
    import ctypes
    from lightningfastspeech2_tpu_torch.kernels import build

    lib = build.load("flash_attention")
    fn = lib.lfs2_flash_attention_last_grid
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    grid = (ctypes.c_int * 3)()
    build.check(lib, fn(which, grid), "flash_attention grid query")
    return grid[0] * grid[1] * grid[2]


def train_kernels_phase(dev) -> dict:
    """The training kernels at the step's shapes: every FFN block of the
    flagship (encoder at P = 256, decoder at T = 2048) timed and held
    against the plain version, in bf16 and, at phase 9's shapes, in f32;
    flash attention at the decoder's shape in bf16 and at phase 9's in
    f32."""
    g = torch.Generator().manual_seed(1)
    enc_k, dec_k = (5, 25, 13, 9), (17, 21, 9, 13)
    ffn = ([_ffn_train_case(dev, TRAIN_B, TRAIN_P, k, g) for k in enc_k]
           + [_ffn_train_case(dev, TRAIN_B, TRAIN_T, k, g) for k in dec_k])
    # the f32 route at phase 9's shapes (B=2, P=128, T=1024)
    ffn_f32 = ([_ffn_train_case(dev, 2, 128, k, g, torch.float32) for k in enc_k]
               + [_ffn_train_case(dev, 2, 1024, k, g, torch.float32) for k in dec_k])
    return {"ffn": ffn, "ffn_f32": ffn_f32, "flash": _flash_case(dev, g),
            "flash_f32": _flash_case(dev, g, torch.float32, B=2, T=1024, rate=0.0)}


# the FFN templates ffn_ln_kernel<CP, kChain> (bf16) and
# ffn_tf32_kernel<C, MT, kChain> (f32) are the forward with kChain false
# and the backward's first launch with kChain true
STEP_FAMILIES = {"ffn_ln_train": (r"ffn_ln_kernel<\d+, false>", r"ffn_tf32_kernel<\d+, \d+, false>"),
                 "ffn_ln_train_bwd": (r"ffn_ln_kernel<\d+, true>", r"ffn_tf32_kernel<\d+, \d+, true>",
                                      "ffn_dup_kernel", "ffn_dup_tf32_kernel", "ffn_dt1_kernel"),
                 "flash_attention": ("fwd_sm90_kernel", "fwd_kernel", "wide_fwd_kernel"),
                 "flash_attention_bwd": ("dq_sm90_kernel", "dkv_sm90_kernel", "dq_kernel", "dkv_kernel",
                                         "wide_dq_kernel", "wide_dkv_kernel"),
                 "ffn_ln_wide": ("ffn_wide_kernel", "ffn_wide_ln2_kernel"),
                 "soft_dtw": "soft_dtw_wave_fwd", "soft_dtw_bwd": "soft_dtw_wave_bwd",
                 "regulate": "regulate_fwd_kernel", "regulate_bwd": "regulate_bwd_kernel",
                 "lvc_stack": ("lvc_mma_kernel", "lvc_stack_kernel"),
                 "resblock": ("wg_resblock_kernel", "mma_resblock_kernel", "f32_resblock_kernel")}


def _step_split(prof, out_name: str = "train_profile.txt", fam=STEP_FAMILIES,
                top: int = 0) -> dict:
    """Device time of one traced step by kernel family (torch.profiler
    key_averages, kernel names matched as whole words); zeros when the
    profiler saw no device time. ``top``: also the ``top`` kernels with
    the most device time (ms, launches, name)."""
    out = {k: 0.0 for k in fam}
    counts = {k: 0 for k in fam}
    total = 0.0
    rows = []
    from torch.autograd import DeviceType

    events = prof.key_averages()
    host_names = {e.key for e in events if e.device_type == DeviceType.CPU}
    for e in events:
        # kernels only: a CPU op (e.g. the autograd Function) that launched
        # a kernel lists the same device time again, and a range the host
        # annotated (e.g. the optimizer's step) reappears on the device
        # spanning kernels already counted
        if e.device_type != DeviceType.CUDA or e.key in host_names:
            continue
        t = e.self_device_time_total
        if t <= 0:
            continue
        total += t
        rows.append((e.key, t, e.count))
        for k, pat in fam.items():
            pats = pat if isinstance(pat, tuple) else (pat,)
            if any(re.search(rf"\b{x}" + ("" if x.endswith(">") else r"\b"), e.key) for x in pats):
                out[k] += t
                counts[k] += e.count
    rows.sort(key=lambda r: -r[1])
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / out_name).write_text(
        "\n".join(f"{t / 1e3:10.3f} ms  x{c:<5d} {k}" for k, t, c in rows))
    return {"device_ms": total / 1e3, "device_launches": sum(c for _, _, c in rows),
            **{f"{k}_ms": v / 1e3 for k, v in out.items()},
            **{f"{k}_launches": v for k, v in counts.items()},
            **({"top_kernels": [[t / 1e3, c, k[:120]] for k, t, c in rows[:top]]} if top else {})}


def reset_counts(counters) -> None:
    """Every launch count to 0, the flash kernels' counts by route and by
    (route, head dim), and ``ffn_ln``'s by width."""
    for c in counters:
        c.launches = 0
        if hasattr(c, "by_route"):
            c.by_route = dict.fromkeys(c.by_route, 0)
        if hasattr(c, "by_head_dim"):
            c.by_head_dim = {}
        if hasattr(c, "by_width"):
            c.by_width = {}


def flash_routes(counters) -> dict:
    """The flash kernels' launches by route."""
    return {c.__name__: dict(c.by_route) for c in counters if hasattr(c, "by_route")}


def flash_head_dims(counters) -> dict:
    """The flash kernels' launches by route and head dim, keyed
    ``"<route> d=<head dim>"``."""
    return {c.__name__: {f"{r} d={d}": n for (r, d), n in sorted(c.by_head_dim.items())}
            for c in counters if hasattr(c, "by_head_dim")}


def soft_dtw_launches_per_step(cfg) -> int:
    """``soft_dtw`` (and ``soft_dtw_bwd``) launches of one teacher-forced
    step, from the config: each soft-DTW loss folds its full chunks into one
    launch, and its tail chunk takes a launch of its own when it has at
    least 8 frames (shorter lattices take the plain recurrence)."""
    m, t = cfg.model, cfg.train
    lengths = [m.max_frames] if t.mel_loss == "soft_dtw" else []
    lengths += [m.max_frames if lvl == "frame" else m.max_phones
                for lvl, kind in zip(m.variance.levels, m.variance.losses) if kind == "soft_dtw"]
    c = t.soft_dtw_chunk_size
    return sum(int(n >= c and c >= 8) + int(n % c >= 8) for n in lengths)


def regulate_launches_per_step(cfg) -> int:
    """``regulate`` (and ``regulate_bwd``) launches of one teacher-forced step
    with the opt-in set: the regulator expands x, and also the phone-level
    variances' summed embedding when there is one
    (models/variance_adaptor.py); both are 3-D and the frame count is a
    multiple of 256."""
    assert cfg.model.max_frames % 256 == 0
    return 1 + int("phone" in cfg.model.variance.levels)


@contextlib.contextmanager
def env_opt_in(name: str):
    """``name=1`` in this process (``LFS2_PALLAS_LR``, ``LFS2_FUSED_STAGE1``),
    as a user who sets it."""
    old = os.environ.get(name)
    os.environ[name] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def training_phase(counters, soft_dtw: bool = False) -> dict:
    """A main path of training: the flagship in bf16 (f32 parameters) takes
    1 warm-up and 5 timed optimizer steps on B=8, P=256, T=2048
    teacher-forced batches, config dropout rates, the l1 mel loss; with
    ``soft_dtw`` (this slice's path, run under ``env_opt_in("LFS2_PALLAS_LR")``), 1
    warm-up and 3 timed steps with the soft-DTW mel loss."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step

    cfg = train_config(mel_loss="soft_dtw" if soft_dtw else "l1")
    batch = train_batch(cfg)
    n_steps = 4 if soft_dtw else 6
    reset_counts(counters)
    t0 = time.perf_counter()
    model = build_fastspeech2(cfg.model, dtype=torch.bfloat16, seed=0)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    gen = torch.Generator(device=model.device).manual_seed(5)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    steps, metrics = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    routes = flash_routes(counters)
    # every parameter's gradient of the last step: finite and not all zero
    # (a kernel detached from autograd would leave zeros)
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.any()]
    finite = all(math.isfinite(v) for m in metrics for v in m.values())
    L_enc, L_dec = cfg.model.encoder.layers, cfg.model.decoder.layers
    want = {c.__name__: 0 for c in counters}
    want.update(ffn_ln_train=n_steps * (L_enc + L_dec), ffn_ln_train_bwd=n_steps * (L_enc + L_dec),
                flash_attention=n_steps * L_dec, flash_attention_bwd=n_steps * L_dec)
    if soft_dtw:
        n_sdtw, n_lr = soft_dtw_launches_per_step(cfg), regulate_launches_per_step(cfg)
        want.update(soft_dtw=n_steps * n_sdtw, soft_dtw_bwd=n_steps * n_sdtw,
                    regulate=n_steps * n_lr, regulate_bwd=n_steps * n_lr)
    timed = steps[1:]
    name = "soft_dtw_training" if soft_dtw else "training"
    row = {"phase": name, "mel_loss": cfg.train.mel_loss,
           "LFS2_PALLAS_LR": os.environ.get("LFS2_PALLAS_LR"), "setup_s": setup_s,
           "steps": n_steps, "step_ms": steps,
           "timed_step_ms_mean": sum(timed) / len(timed),
           "frames_per_s": TRAIN_B * TRAIN_T / (sum(timed) / len(timed) / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "first_losses": metrics[0], "last_losses": metrics[-1], "finite": finite,
           "params_without_grad": bad, "launches": launches, "expected": want,
           "flash_routes": routes, "flash_head_dims": flash_head_dims(counters)}
    emit(row)
    if not finite or bad:
        raise RuntimeError(f"{name}: finite={finite}, params without gradient {bad[:8]}")
    if launches != want:
        raise RuntimeError(f"{name}-path launches {launches}, expected {want}")
    # the bf16 step's attention went through the wgmma kernels alone
    want_routes = {k: {**dict.fromkeys(v, 0), "flash_attention_sm90": want[k]}
                   for k, v in routes.items()}
    if routes != want_routes:
        raise RuntimeError(f"{name}: flash launches by route {routes}, expected {want_routes}")
    # one more step under the profiler (outside the counted run): where the
    # step's device time goes
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
    split = _step_split(prof, f"{name}_profile.txt")
    flash_ms = split["flash_attention_ms"] + split["flash_attention_bwd_ms"]
    emit({"phase": f"{name}_profile", **split, "flash_share_ms": flash_ms,
          "flash_share": flash_ms / split["device_ms"] if split["device_ms"] else None})

    def one_step() -> float:
        """One more step (outside the counted run), its host-clock ms."""
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    return {"row": row, "split": split, "one_step": one_step}


def train_reference_phase(soft_dtw: bool = False) -> dict:
    """One f32 optimizer step on the card (kernels) against the same step on
    the CPU (plain versions): flagship widths, B=2, T=1024 so the flash gate
    admits the decoder, every dropout rate 0 (the generators differ); with
    ``soft_dtw``, the soft-DTW mel loss (run under ``env_opt_in("LFS2_PALLAS_LR")``, so
    the card's regulator runs its kernels too)."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step

    from lightningfastspeech2_tpu_torch.core.config import replace

    shape = (2, 128, 1024)
    cfg = train_config(rates=False, B_P_T=shape, mel_loss="soft_dtw" if soft_dtw else "l1")
    # lr 1e-4 at the first update (the flagship's 4000-step warm-up would
    # make it 2.5e-8, below the f32 resolution of the parameters)
    cfg = replace(cfg, train=replace(cfg.train, warmup_steps=1))
    batch = train_batch(cfg, shape)
    from lightningfastspeech2_tpu_torch.ops.attention import flash_attention, flash_attention_bwd
    from lightningfastspeech2_tpu_torch.ops.ffn import ffn_ln_train, ffn_ln_train_bwd

    res = {}
    reset_counts((flash_attention, flash_attention_bwd, ffn_ln_train, ffn_ln_train_bwd))
    for dev in ("cuda", "cpu"):
        model = build_fastspeech2(cfg.model, dtype=torch.float32, device=dev, seed=0)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        state = create_train_state(model, cfg)
        step = make_train_step(model, cfg)
        state, m = step(state, batch, torch.Generator(device=dev))
        res[dev] = {
            "losses": {k: float(v) for k, v in m.items()},
            "grad": {n: state.optimizer.state[p]["exp_avg"].cpu() / 0.1
                     for n, p in model.named_parameters()},
            "update": {n: (p.detach() - before[n]).cpu() for n, p in model.named_parameters()}}
        if dev == "cuda":
            # the counted step's FFN launches, then one more step under the
            # profiler (after the step's gradients and update were taken):
            # the f32 FFN kernels' share of the step
            ffn_counts = {c.__name__: c.launches for c in (ffn_ln_train, ffn_ln_train_bwd)}
            routes = flash_routes((flash_attention, flash_attention_bwd))
            head_dims = flash_head_dims((flash_attention, flash_attention_bwd))
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step(state, batch, torch.Generator(device=dev))
                torch.cuda.synchronize()
            split = _step_split(prof, f"{'soft_dtw_' if soft_dtw else ''}train_reference_profile.txt")
    a, b = res["cuda"], res["cpu"]
    loss_err = max(abs(a["losses"][k] - v) / max(abs(v), 1e-6) for k, v in b["losses"].items())
    gmax = max(g.abs().max().item() for g in b["grad"].values())
    grad_err = max((a["grad"][n] - g).abs().max().item() for n, g in b["grad"].items())
    lr = max(u.abs().max().item() for u in b["update"].values())
    upd_err = 0.0
    for n, g in b["grad"].items():
        sure = g.abs() > 1e-2 * gmax
        if sure.any():
            upd_err = max(upd_err, (a["update"][n] - b["update"][n])[sure].abs().max().item())
    # f32 on both sides, TF32 off: losses to 1e-4 relative; gradients to
    # 1e-3 of the largest; the Adam update (about lr * sign(g) at the first
    # step) to 1 % of its size where |g| > 1 % of the largest gradient
    tol = {"loss_rel": 1e-4, "grad_abs": 1e-3 * gmax, "update_abs": 1e-2 * lr}
    name = "soft_dtw_train_reference" if soft_dtw else "train_reference"
    row = {"phase": name, "at": f"flagship f32, B=2, P=128, T=1024, rates 0, mel loss "
                               f"{cfg.train.mel_loss}",
           "loss_rel_err": loss_err, "grad_max_abs_err": grad_err, "grad_max": gmax,
           "update_max_abs_err": upd_err, "update_max": lr, "tol": tol,
           "losses_cuda": a["losses"], "losses_cpu": b["losses"],
           "flash_routes": routes, "flash_head_dims": head_dims, "ffn_launches": ffn_counts,
           "profiled_step": {k: split[k] for k in (
               "device_ms", "device_launches", "ffn_ln_train_ms", "ffn_ln_train_launches",
               "ffn_ln_train_bwd_ms", "ffn_ln_train_bwd_launches")}}
    emit(row)
    # the f32 step's attention went through the split-TF32 kernels alone
    n_dec = cfg.model.decoder.layers
    want_routes = {k: {**dict.fromkeys(v, 0), "flash_attention": n_dec}
                   for k, v in row["flash_routes"].items()}
    if row["flash_routes"] != want_routes:
        raise RuntimeError(f"{name}: flash launches by route {row['flash_routes']}, "
                           f"expected {want_routes}")
    n_ffn = cfg.model.encoder.layers + cfg.model.decoder.layers
    if ffn_counts != {"ffn_ln_train": n_ffn, "ffn_ln_train_bwd": n_ffn}:
        raise RuntimeError(f"{name}: ffn launches {ffn_counts}, expected {n_ffn} each")
    if not (loss_err <= tol["loss_rel"] and grad_err <= tol["grad_abs"]
            and upd_err <= tol["update_abs"]):
        raise RuntimeError(f"train step card vs CPU: {row}")
    return row


# ------------------------------------------------------- soft-DTW slice
def _soft_dtw_case(dev, g) -> dict:
    """soft_dtw forward and backward at the mel loss's lattices: 8 items x 8
    chunks of 256 frames, D from 80 channels (a bf16 prediction against an
    f32 target, as in the step), gamma 0.1; each kernel also alone against
    its plain twin (the forward's residual, the backward on the plain
    residual), and each launch against ``soft_dtw_plan``."""
    from lightningfastspeech2_tpu_torch.ops import soft_dtw as sd

    chunk, C, gamma = 256, 80, 0.1
    L = TRAIN_B * TRAIN_T // chunk
    pred = (0.5 * torch.randn(L, chunk, C, generator=g)).to(dev, torch.bfloat16)
    truth = torch.randn(L, chunk, C, generator=g).to(dev)
    D = sd.pairwise_sqdist(pred, truth).contiguous()
    up = torch.ones(L, device=dev)       # the loss sums the lattices' values
    Dk = D.clone().requires_grad_(True)
    val = sd.soft_dtw_from_dist(Dk, gamma)
    (grad,) = torch.autograd.grad(val, Dk, up)
    launch = sd.last_launch()
    Dp = D.clone().requires_grad_(True)
    ref = sd.soft_dtw_from_dist_plain(Dp, gamma)
    (ref_grad,) = torch.autograd.grad(ref, Dp, up, retain_graph=True)
    # each kernel alone: the forward's residual against the plain forward on
    # the lattice's cells, the backward on the plain residual against the
    # plain backward
    _, W = sd.soft_dtw_fwd(D, gamma)
    _, W_ref = sd.soft_dtw_fwd_plain(D, gamma)
    on = sd.residual_cells(chunk, chunk, dev)
    w_err = (W - W_ref).abs()[:, on]
    dD_alone = sd.soft_dtw_bwd(W_ref, up, chunk)
    dD_plain = sd.soft_dtw_bwd_plain(W_ref, up, chunk)
    torch.cuda.synchronize()
    plan = sd.soft_dtw_plan(L, chunk, chunk)
    # f32 on both sides with the same softmin: the value to 1e-5 relative,
    # dD (alignment weights in [0, 1]) to 1e-4 of its largest element; the
    # residual (weights in [0, 1]) differs where ex2 / lg2 / rcp.approx
    # against exp2 / log2 / division move R by an ulp in a near tie, by at
    # most ulp(R) / (4 gamma): 1e-3 at most, 1e-7 on average; the backward
    # alone sums the same products in the same order, one of them fused:
    # 1e-5 of its largest
    v_err = ((val - ref).abs() / ref.abs()).max().item()
    g_err, g_tol = (grad - ref_grad).abs().max().item(), 1e-4 * ref_grad.abs().max().item()
    alone_err = (dD_alone - dD_plain).abs().max().item()
    alone_tol = 1e-5 * dD_plain.abs().max().item()
    at = f"D ({L}, {chunk}, {chunk}) f32 from {C} channels, gamma {gamma}"
    cells = L * chunk * chunk
    # the function's bytes, each input read once and each output written
    # once: D in and one float a cell (R) out, then that float in and dD out;
    # the residual's other two floats a cell are this design's cost, shown
    # beside the bound. f32 operations a cell: the forward's softmin 17 (6
    # min / max, 2 ex2, lg2, 8 adds and products), its weights 15 (rcp, 2
    # products, 6 compares, 6 selects); the backward's recurrence 5
    res_bytes = 3 * cells * 4
    row_f = {"name": "soft_dtw", "at": at, "max_abs_err": (val - ref).abs().max().item(),
             "value_rel_err": v_err, "tol": "1e-5 relative",
             "residual_max_abs_err": w_err.max().item(),
             "residual_mean_abs_err": w_err.mean().item(), "residual_tol": [1e-3, 1e-7],
             "residual_bytes": res_bytes, "residual_alloc_bytes": plan.residual_bytes,
             "residual_bytes_beyond_bound": res_bytes - 4 * cells,
             "launch": launch["fwd"], "plan": plan.fwd.record,
             "serial_diagonals": 2 * chunk - 1,
             "ms": cuda_ms(lambda: sd.soft_dtw_fwd(D, gamma)),
             "plain_ms": cuda_ms(lambda: sd.soft_dtw_from_dist_plain(D, gamma), max_iters=5),
             "plain_kernel_contract_ms": cuda_ms(lambda: sd.soft_dtw_fwd_plain(D, gamma),
                                                 max_iters=3),
             "library_ms": None}
    row_b = {"name": "soft_dtw_bwd", "at": at, "max_abs_err": g_err, "tol": g_tol,
             "alone_max_abs_err": alone_err, "alone_tol": alone_tol,
             "residual_bytes_beyond_bound": res_bytes - 4 * cells,
             "launch": launch["bwd"], "plan": plan.bwd.record,
             "serial_diagonals": 2 * chunk - 1,
             "ms": cuda_ms(lambda: sd.soft_dtw_bwd(W, up, chunk)),
             "plain_ms": cuda_ms_grad(ref, Dp, up, max_iters=5),
             "plain_kernel_contract_ms": cuda_ms(lambda: sd.soft_dtw_bwd_plain(W_ref, up, chunk),
                                                 max_iters=3),
             "library_ms": None}
    row_f["bound_ms"], row_f["bound_by"] = bound_ms(32 * cells, 8 * cells + 4 * L, torch.float32)
    row_b["bound_ms"], row_b["bound_by"] = bound_ms(5 * cells, 8 * cells + 4 * L, torch.float32)
    for r in (row_f, row_b):
        emit({"phase": "kernel", **r})
    if not (v_err <= 1e-5 and g_err <= g_tol and alone_err <= alone_tol
            and w_err.max().item() <= 1e-3 and w_err.mean().item() <= 1e-7):
        raise RuntimeError(f"soft_dtw at {at}: value rel err {v_err}, dD err {g_err} > {g_tol}, "
                           f"backward alone {alone_err} > {alone_tol}, residual "
                           f"{w_err.max().item()} / {w_err.mean().item()}")
    if (launch["fwd"], launch["bwd"]) != (plan.fwd.record, plan.bwd.record):
        raise RuntimeError(f"soft_dtw launched {launch}, planned {plan}")
    return {"fwd": row_f, "bwd": row_b}


def device_kernels(fn, calls: int = 20, windows: int = 3) -> dict:
    """``calls`` calls of ``fn`` under torch.profiler: the device kernels
    (copies and fills included) a call, by name without arguments or
    template arguments, and the device ms a call. The profiler on this card
    now and then drops a kernel's record, or a whole window's: each name
    counts round(records / calls) kernels a call (at least one once seen),
    its ms the mean of its records, and of up to ``windows`` windows the one
    with the most records is kept. ``scripts/bench_length_regulator.py`` and
    the card tests count kernels with it too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        host = {e.key for e in events if e.device_type == DeviceType.CPU}
        rows = {}
        for e in events:
            if e.device_type == DeviceType.CUDA and e.key not in host and e.count:
                name = re.split(r"[<(]", e.key.removeprefix("void ").replace(
                    "(anonymous namespace)::", ""), maxsplit=1)[0]
                t, c = rows.get(name, (0.0, 0))
                rows[name] = (t + e.self_device_time_total, c + e.count)
        records = sum(c for _, c in rows.values())
        if best is None or records > best[0]:
            best = (records, rows)
        if records and all(c % calls == 0 for _, c in rows.values()):
            break
    records, rows = best
    by_name = {n: {"ms": t / c / 1e3, "a_call": max(1, round(c / calls)), "records": c}
               for n, (t, c) in rows.items()}
    return {"device_ms": sum(v["ms"] * v["a_call"] for v in by_name.values()),
            "kernels": sum(v["a_call"] for v in by_name.values()), "names": sorted(by_name),
            "by_name": by_name, "records": records, "calls": calls}


def _regulate_case(dev, g) -> dict:
    """The regulator's two kernels at the flagship's shape: x (8, 256, 256)
    bf16 -> 2048 frames, int64 durations as the model rounds them, ragged (a
    zero-duration phone every fifth, one item over T), against the gather;
    device ms from the profiler beside the event ms and host µs, and one
    device kernel a direction."""
    from lightningfastspeech2_tpu_torch.ops import length_regulator as lr

    B, P, H, T, dtype = TRAIN_B, TRAIN_P, 256, TRAIN_T, torch.bfloat16
    x = torch.randn(B, P, H, generator=g).to(dev, dtype)
    d = torch.randint(1, 14, (B, P), generator=g)
    d[:, ::5] = 0
    d[0] = 10                              # 2560 frames: above T
    d = d.to(dev)
    dout = torch.randn(B, T, H, generator=g).to(dev, dtype)
    xk = x.clone().requires_grad_(True)
    frames, mask = lr.regulate_kernel(xk, d, T)
    (grad,) = torch.autograd.grad(frames, xk, dout, retain_graph=True)
    ref, ref_mask = lr.regulate_plain(x, d, T)
    _, _, ends = lr.regulate_fwd(x, d, T)
    want_ends = torch.cumsum(d.clamp(min=0).to(torch.int32), -1, dtype=torch.int32)
    # the backward adds in f32 and rounds once: against the f32 gather's
    # gradient of the same inputs, rounded once, within one bf16 ulp
    xf = x.float().requires_grad_(True)
    (want,) = torch.autograd.grad(lr.regulate_plain(xf, d, T)[0], xf, dout.float())
    want = want.to(dtype).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    torch.cuda.synchronize()
    exact = torch.equal(frames, ref) and torch.equal(mask, ref_mask)
    g_err = (grad.float() - want).abs()
    at = f"x ({B}, {P}, {H}) bf16 -> {T} frames, int64 ragged durations"
    # the gather as one PyTorch call on the precomputed frame -> phone index
    t = torch.arange(T, device=dev)
    idx = torch.searchsorted(ends.long(), t.expand(B, T).contiguous(), right=True).clamp(max=P - 1)
    idx = idx[:, :, None].expand(-1, -1, H)
    xg = x.clone().requires_grad_(True)
    gathered = torch.gather(xg, 1, idx)
    pp = x.clone().requires_grad_(True)
    plain_out = lr.regulate_plain(pp, d, T)[0]

    def call():                            # as in training: x needs its gradient
        return lr.regulate_kernel(xk, d, T)

    def call_bwd():
        return torch.autograd.grad(frames, xk, dout, retain_graph=True)

    def gather_bwd():
        return torch.autograd.grad(gathered, xg, dout, retain_graph=True)

    fwd_prof, bwd_prof = device_kernels(call), device_kernels(call_bwd)
    lib_prof = device_kernels(lambda: torch.gather(x, 1, idx))
    lib_bwd_prof = device_kernels(gather_bwd)
    # ms: the kernel's device time a launch (torch.profiler); event_ms: CUDA
    # events around a run of wrapper calls, which follow the host where it
    # is slower; host_us: the whole regulate_kernel call (mask included) or
    # its backward through autograd, on the host clock; plain_ms: events
    # around regulate_plain (the gather and its index work) or its backward
    row_f = {"name": "regulate", "at": at,
             "max_abs_err": (frames.float() - ref.float()).abs().max().item(),
             "tol": 0.0, "bit_exact": exact, "ends_equal": torch.equal(ends, want_ends),
             "ms": fwd_prof["device_ms"], "kernels_a_call": fwd_prof["kernels"],
             "kernel_names": fwd_prof["names"], "profiler_records": fwd_prof["records"],
             "event_ms": cuda_ms(lambda: lr.regulate_fwd(x, d, T)),
             "plain_ms": cuda_ms(lambda: lr.regulate_plain(x, d, T)),
             "library_ms": lib_prof["device_ms"],
             "library_event_ms": cuda_ms(lambda: torch.gather(x, 1, idx)),
             "library": "torch.gather on the precomputed frame -> phone index"}
    row_b = {"name": "regulate_bwd", "at": at, "max_abs_err": g_err.max().item(),
             "tol": "one bf16 ulp of the f32 gather's gradient rounded once",
             "ms": bwd_prof["device_ms"], "kernels_a_call": bwd_prof["kernels"],
             "kernel_names": bwd_prof["names"], "profiler_records": bwd_prof["records"],
             "event_ms": cuda_ms(lambda: lr.regulate_bwd(dout, ends)),
             "plain_ms": cuda_ms_grad(plain_out, pp, dout),
             "library_ms": lib_bwd_prof["device_ms"],
             "library_event_ms": cuda_ms_grad(gathered, xg, dout),
             "library_fwd_bwd_ms": cuda_ms(lambda: torch.autograd.grad(
                 torch.gather(xg, 1, idx), xg, dout)),
             "library": "torch.gather's backward (a fill and a scatter-add)"}
    row_f["host_us"] = host_us(call, 2000)
    row_f["launch_host_us"] = host_us(lambda: lr.regulate_fwd(x, d, T), 2000)
    row_f["library_host_us"] = host_us(lambda: torch.gather(x, 1, idx), 2000)
    row_b["host_us"] = host_us(call_bwd, 2000)
    row_b["launch_host_us"] = host_us(lambda: lr.regulate_bwd(dout, ends), 2000)
    row_b["library_host_us"] = host_us(gather_bwd, 2000)
    # the bytes this run's data needs, each read or written once: the
    # durations, the x rows that own a frame below T, frames, mask and ends;
    # g's frames below each item's total, ends and dx
    row_bytes = H * x.element_size()
    starts = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
    x_rows = int(((ends > starts) & (starts < T)).sum())
    g_rows = int(ends[:, -1].clamp(max=T).sum())
    nb_f = B * T * row_bytes
    row_f["bound_ms"], row_f["bound_by"] = bound_ms(
        0, tensor_bytes(d, ends, mask) + x_rows * row_bytes + nb_f, dtype)
    row_b["bound_ms"], row_b["bound_by"] = bound_ms(
        g_rows * H, g_rows * row_bytes + tensor_bytes(ends) + tensor_bytes(x), dtype)
    for r in (row_f, row_b):
        emit({"phase": "kernel", **r})
    if not exact or not row_f["ends_equal"] or not bool((g_err <= ulp).all()):
        raise RuntimeError(f"regulate at {at}: forward bit-exact {exact}, ends "
                           f"{row_f['ends_equal']}, gradient off by {g_err.max().item()}")
    if (fwd_prof["kernels"], bwd_prof["kernels"]) != (1, 1):
        raise RuntimeError(f"regulate at {at}: a forward call ran {fwd_prof['names']} "
                           f"({fwd_prof['kernels']} kernels), a backward {bwd_prof['names']} "
                           f"({bwd_prof['kernels']}); one kernel a direction expected")
    return {"fwd": row_f, "bwd": row_b}


def sdtw_kernels_phase(dev) -> dict:
    g = torch.Generator().manual_seed(2)
    return {"soft_dtw": _soft_dtw_case(dev, g), "regulate": _regulate_case(dev, g)}


# ------------------------------------------------------- FastDiff slice
FD_BUCKET = 512   # the served batch's frame bucket
FD_CALL_RUNS = 5  # timed vocoder calls: their median and spread


def _lvc_case(dev, g, hop, dtype, fast=False, nL=FD_BUCKET, C=32) -> dict:
    """lvc_stack at one upsample stage of a FD_BUCKET-frame bucket, B=1, 4
    layers, C channels (the inputs drawn on ``g``'s device), against the
    plain version; the biases in the working dtype, as the kernel predictor
    gives them. At a width the kernel is not built at, the padding's copy
    is timed too (``pad_copy_ms``, part of ``ms``)."""
    from lightningfastspeech2_tpu_torch.ops import fastdiff_lvc as lvc

    B, layers = 1, 4
    L = nL * hop

    def draw(*shape):
        return torch.randn(*shape, generator=g, device=g.device)

    x = draw(B, L, C).to(dev, dtype)
    ad = draw(B, L, C).to(dev, dtype)
    k = (0.2 * draw(B, nL, layers, C, 2 * C, 3)).to(dev, dtype)
    b = (0.1 * draw(B, nL, layers, 2 * C)).to(dev, dtype)
    cw = (0.1 * draw(layers, 3, C, C)).to(dev, dtype)
    cb = (0.1 * draw(layers, C)).to(dev)
    args = (x, ad, k, b, cw, cb, hop)
    out = lvc.lvc_stack(*args, fast_gating=fast)
    launched = lvc.last_launch()  # as the library gave it to the card
    ref = lvc.lvc_stack_plain(*args, fast_gating=fast)
    torch.cuda.synchronize()
    top = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    held = {}
    if dtype == torch.float32:   # summation order only
        tol = 2e-4 * (1.0 + top)
        ok = err <= tol
    else:   # per value, in ulps of the chain's |x| there (lvc.bf16_chain_error)
        ulps, share = lvc.bf16_chain_error(out, ref, x, ad, layers)
        most_ulps, most_unequal = lvc.bf16_chain_limits(C)
        tol = f"{most_ulps} ulps a value, {most_unequal} of values unequal"
        held = {"max_ulps": ulps, "unequal_share": share}
        ok = ulps <= most_ulps and share <= most_unequal
    # per row and layer: the dilated conv (3C x C) and the LVC (3C x 2C);
    # bf16 at the tensor cores' peak, f32 as split-TF32 products
    flops = B * L * layers * 2 * (3 * C * C + 3 * C * 2 * C)
    nbytes = 2 * tensor_bytes(x) + tensor_bytes(ad, k, b, cw, cb)
    peak = PEAK_FLOPS[dtype] if dtype == torch.bfloat16 else PEAK_F32_ACCURATE
    plan = lvc.lvc_plan(B, L, hop, layers, dtype, C)
    row = {"name": "lvc_stack", "stage": {8: 1, 64: 2, 256: 3}.get(hop),
           "at": f"x ({B}, {L}, {C}) {str(dtype)[6:]}, hop {hop}, {nL} frames, {layers} layers, "
                 f"{'Padé' if fast else 'exact'} gate",
           "max_abs_err": err, "tol": tol, **held, "route": plan.route, "channels": C,
           "kernel_channels": plan.channels,
           "launch": launched, "plan": plan.record, "halo": plan.halo,
           "frames": plan.frames,
           "ms": cuda_ms(lambda: lvc.lvc_stack(*args, fast_gating=fast)),
           "plain_ms": cuda_ms(lambda: lvc.lvc_stack_plain(*args, fast_gating=fast)),
           "library_ms": None, "bytes": nbytes, "flops": flops,
           "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "ops_ms": flops / peak * 1e3}
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, dtype, peak)
    row["x_bound"] = row["ms"] / row["bound_ms"]
    if plan.route == lvc.WIDE_ROUTE and plan.channels != C:   # the signal and the taps
        row["pad_copy_ms"] = cuda_ms(lambda: lvc.pad_wide_inputs(x, ad, cw, cb, plan.channels))
    elif plan.channels != C:
        row["pad_copy_ms"] = cuda_ms(lambda: lvc.pad_lvc_inputs(*args[:6], plan.channels))
    emit({"phase": "kernel", **row})
    if not ok:
        raise RuntimeError(f"lvc_stack at {row['at']}: max |err| {err} {held}, tolerance {tol}")
    if launched != plan.record:
        raise RuntimeError(f"lvc_stack at {row['at']}: launched {launched}, planned {plan}")
    return row


def fastdiff_kernels_phase(dev) -> dict:
    """lvc_stack at stages 2 and 3 in bf16 and f32, the Padé gate at stage
    3, and the stage-1 shape (hop 8, the LFS2_FUSED_STAGE1 opt-in) in both
    dtypes; the rows by name."""
    g = torch.Generator().manual_seed(3)
    bf, f32 = torch.bfloat16, torch.float32
    return {"stage2": _lvc_case(dev, g, 64, bf), "stage3": _lvc_case(dev, g, 256, bf),
            "stage2_f32": _lvc_case(dev, g, 64, f32), "stage3_f32": _lvc_case(dev, g, 256, f32),
            "stage3_pade": _lvc_case(dev, g, 256, bf, fast=True),
            "stage1": _lvc_case(dev, g, 8, bf), "stage1_f32": _lvc_case(dev, g, 8, f32)}


def fastdiff_serving_phase(counters, served) -> dict:
    """This slice's main path: the flagship with its residual head and the
    FastDiff vocoder (reference widths, N from the config), both bf16 from
    seeded generators, phase 5's dvectors and duration bias; then one
    request under LFS2_FUSED_STAGE1 and one profiled vocoder call."""
    from lightningfastspeech2_tpu_torch.core.config import replace
    from lightningfastspeech2_tpu_torch.ops.fastdiff_lvc import lvc_stack, routes_to_kernel

    cfg = served["cfg"]
    cfg = replace(cfg, model=replace(cfg.model, fastdiff_vocoder=True))
    dvecs = served["dvecs"]
    reset_counts(counters)
    t0 = time.perf_counter()
    gen, _ = _make_generator(cfg, torch.bfloat16, None, dvecs, BATCH_TEXTS, served["bias"],
                             fastdiff=True)
    synth = gen.synthesiser
    fd_cfg, N = synth.vocoder.cfg, synth.n_steps
    emit({"phase": "fastdiff_serving_setup", "seconds": time.perf_counter() - t0,
          "fastdiff": {"inner_channels": fd_cfg.inner_channels,
                       "upsample_ratios": list(fd_cfg.upsample_ratios),
                       "lvc_layers": fd_cfg.lvc_layers_each_block,
                       "kpnet_hidden": fd_cfg.kpnet_hidden_channels, "T": fd_cfg.T,
                       "N": N, "dtype": "bfloat16"}})
    run = _serve_all(gen, cfg, dvecs, tag="fastdiff_")
    launches = {c.__name__: c.launches for c in counters}
    # per generate_samples call the acoustic passes' ffn_ln launches, as in
    # phase 5; per vocoder call N ε passes, each one lvc_stack launch per
    # stage the routing rule sends to the kernel at that call's bucket
    hops, hop = [], 1
    for r in fd_cfg.upsample_ratios:
        hop *= r
        hops.append(hop)
    layers = fd_cfg.lvc_layers_each_block
    m = cfg.model
    want = {c.__name__: 0 for c in counters}
    want.update({"ffn_ln": run["n_calls"] * (2 * m.encoder.layers + m.decoder.layers),
                 "lvc_stack": sum(N * sum(routes_to_kernel(h, T, layers) for h in hops)
                                  for T in run["vocoder_buckets"])})
    n_voc = len(run["vocoder_buckets"])
    emit({"phase": "fastdiff_launches", **launches, "expected": want, "vocoder_calls": n_voc,
          "eps_passes": N * n_voc})
    if launches != want or want["lvc_stack"] != 2 * N * n_voc or launches["ffn_ln"] == 0:
        raise RuntimeError(f"FastDiff serving launches {launches}, expected {want} "
                           f"(2 per pass x {N} x {n_voc} calls)")
    # one request with the stage-1 opt-in (outside the counted run above)
    n = lvc_stack.launches
    with env_opt_in("LFS2_FUSED_STAGE1"):
        t = time.perf_counter()
        wav = gen.generate_from_text(SENTENCES[0], speaker="spk0", seed=0)
        opt_ms = (time.perf_counter() - t) * 1e3
    opt_launches = lvc_stack.launches - n
    emit({"phase": "fastdiff_stage1_opt_in", "lvc_stack": opt_launches, "expected": 3 * N,
          "ms": opt_ms, "finite": bool(np.isfinite(wav).all())})
    if opt_launches != 3 * N or not np.isfinite(wav).all():
        raise RuntimeError(f"LFS2_FUSED_STAGE1 request: {opt_launches} lvc_stack launches, "
                           f"expected {3 * N}")
    # vocoder calls on a FD_BUCKET-frame mel in bf16, then in f32 (the
    # generate CLI's default --vocoder_precision 32)
    mel = (np.random.default_rng(5).standard_normal((FD_BUCKET, m.audio.n_mels)) - 4.0
           ).astype(np.float32)
    call, prof = _vocoder_call(synth, mel, "")
    # the host side of the same call: PyTorch ops by their own CPU time
    from torch.autograd import DeviceType

    host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    (ROOT / "chiprun_out" / "fastdiff_vocoder_host_profile.txt").write_text(
        "\n".join(f"{e.self_cpu_time_total / 1e3:10.3f} ms  x{e.count:<6d} {e.key}"
                  for e in host[:60]))
    hifigan_ms = statistics.median(r["ms"] for r in served["requests"])
    fastdiff_ms = statistics.median(r["ms"] for r in run["requests"])
    emit({"phase": "fastdiff_vocoder_profile", "frames": FD_BUCKET, "N": N, **call,
          "request_ms_median": {"fastdiff": fastdiff_ms, "hifigan_v1": hifigan_ms},
          "batch_audio_s_per_s": {"fastdiff": run["batch"]["audio_s_per_s"],
                                  "hifigan_v1": served["batch"]["audio_s_per_s"]}})
    from lightningfastspeech2_tpu_torch.synthesis.generator import FastDiffSynthesiser

    synth32 = FastDiffSynthesiser(cfg.model, vocoder_precision=32, seed=1)
    call32, _ = _vocoder_call(synth32, mel, "_f32")
    emit({"phase": "fastdiff_vocoder_profile_f32", "frames": FD_BUCKET, "N": N, **call32})
    if call32["lvc_stack_launches"] != 2 * N or call["lvc_stack_launches"] != 2 * N:
        raise RuntimeError(f"profiled vocoder calls: lvc_stack kernels "
                           f"{call['lvc_stack_launches']} (bf16), "
                           f"{call32['lvc_stack_launches']} (f32), expected {2 * N}")
    return {"launches": launches, "cfg": cfg, "run": run, "split": call, "split_f32": call32}


def _vocoder_call(synth, mel, tag: str):
    """One vocoder call on ``mel``, warmed up, timed FD_CALL_RUNS times on
    the host clock (median), then once under the profiler: device ms and
    launches, ``lvc_stack``'s kernel ms and launches (the kernel table in
    fastdiff_vocoder_profile{tag}.txt), and the profiler."""
    synth(mel)
    torch.cuda.synchronize()
    call_runs = []
    for _ in range(FD_CALL_RUNS):
        t = time.perf_counter()
        synth(mel)
        torch.cuda.synchronize()
        call_runs.append((time.perf_counter() - t) * 1e3)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        synth(mel)
        torch.cuda.synchronize()
    split = _step_split(prof, f"fastdiff_vocoder_profile{tag}.txt")
    return {"call_ms": statistics.median(call_runs), "call_ms_runs": call_runs,
            "device_ms": split["device_ms"], "device_launches": split["device_launches"],
            "lvc_stack_ms": split["lvc_stack_ms"],
            "lvc_stack_launches": split["lvc_stack_launches"],
            "rest_device_ms": split["device_ms"] - split["lvc_stack_ms"]}, prof


# ------------------------------------------------------- the generate CLI
# a short sentence with a word in no lexicon: the neural G2P spells it
CLI_SENTENCE = "Hello zyxwort world."
CLI_OOV = "zyxwort"
CLI_RUNS = 5   # timed requests after one warm call: their median
# kernel routes by the names torch.profiler gives the device kernels
CLI_ROUTES = {"ffn_ln_f32": r"ffn_tf32_kernel<\d+, \d+, false>",
              "ffn_ln_bf16": r"ffn_ln_kernel<\d+, false>",
              "resblock_f32": "f32_resblock_kernel",
              "resblock_bf16": ("wg_resblock_kernel", "mma_resblock_kernel"),
              "lvc_stack": ("lvc_mma_kernel", "lvc_stack_kernel"),
              "probe": "probe_kernel"}


def write_cli_checkpoints(root: Path) -> dict:
    """Port checkpoints of the flagship with pitch and energy priors and
    their stats, two d-vector speakers with prior histories, and the
    prior and d-vector GMMs (made from seeded parameters as the port's own
    LogGMMs: this machine has no scikit-learn to fit them); and a joint one,
    the flagship with its residual head and FastDiff at reference widths.
    Weights from seeded generators; the duration head gives every phone 7
    frames."""
    from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer
    from lightningfastspeech2_tpu_torch.core.config import lightspeech_flagship, replace
    from lightningfastspeech2_tpu_torch.data.vocab import ARPABET_TO_IPA, PUNCTUATION_TOKENS, SILENCE
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.models.joint import make_fastdiff_config
    from lightningfastspeech2_tpu_torch.utils.log_gmm import make_log_gmm
    from lightningfastspeech2_tpu_torch.vocoder.fastdiff import FastDiffVocoder

    phones = sorted(set(ARPABET_TO_IPA.values()) | set(PUNCTUATION_TOKENS.values()) | {SILENCE})
    phone2id = {"[PAD]": 0, **{p: i + 1 for i, p in enumerate(phones)}}
    cfg = lightspeech_flagship()
    cfg = replace(cfg, model=replace(cfg.model, priors=("pitch", "energy"),
                                     vocab_size=len(phone2id)))
    g = np.random.default_rng(0)
    dvecs = {}
    for i in range(2):
        v = g.standard_normal(cfg.model.dvector_dim)
        dvecs[f"spk{i}"] = (v / np.linalg.norm(v)).astype(np.float32)
    history = {s: {"pitch": g.uniform(110.0, 230.0, 50), "energy": g.uniform(0.2, 0.9, 50)}
               for s in dvecs}
    stats = {v: {"min": -2.0, "max": 3.0, "mean": 0.0, "std": 1.0}
             for v in cfg.model.variance.variances}
    stats["priors_pitch"] = {"min": 100.0, "max": 240.0, "mean": 165.0, "std": 35.0}
    stats["priors_energy"] = {"min": 0.1, "max": 1.0, "mean": 0.55, "std": 0.2}
    sidecar = {"phone2id": phone2id, "stats": stats, "speaker2dvector": dvecs,
               "speaker2priors": history}
    D = cfg.model.dvector_dim
    prior_gmms, dvector_gmms = {}, {}
    for s, v in dvecs.items():
        # pitch and energy max-scaled and log-transformed, as fit_speaker_gmms
        mean = np.log(np.array([[150.0, 0.4], [200.0, 0.7]]) / np.array([240.0, 1.0]))
        prior_gmms[s] = make_log_gmm([0.45, 0.55], mean, [np.diag([0.01, 0.04])] * 2,
                                     [240.0, 1.0], logs=[0, 1])
        dvector_gmms[s] = make_log_gmm([0.5, 0.5], [v, 0.9 * v], [np.eye(D) * 1e-4] * 2,
                                       np.ones(D))

    def model_state(mcfg, fastdiff_head):
        model = build_fastspeech2(mcfg, device="cpu", seed=0, use_fastdiff_head=fastdiff_head)
        with torch.no_grad():
            head = model.variance_adaptor.duration_predictor.linear
            head.weight.zero_()
            head.bias.fill_(math.log(8.0))   # round(exp(log 8) - 1) = 7 frames a phone
        return model.state_dict()

    dirs = {"acoustic": root / "ckpt", "joint": root / "joint"}
    Checkpointer(dirs["acoustic"]).save(1, model_state(cfg.model, False), cfg, sidecar)
    jcfg = replace(cfg, model=replace(cfg.model, fastdiff_vocoder=True))
    fd = FastDiffVocoder(make_fastdiff_config(jcfg.model), device="cpu", seed=1).model
    Checkpointer(dirs["joint"]).save(
        1, {"acoustic": model_state(jcfg.model, True), "fastdiff": fd.state_dict()},
        jcfg, sidecar)
    for d in dirs.values():
        (d / "prior_gmms.pkl").write_bytes(pickle.dumps(prior_gmms))
        (d / "dvector_gmms.pkl").write_bytes(pickle.dumps(dvector_gmms))
    return {k: str(v) for k, v in dirs.items()}


def _route_split(prof, out_name: str) -> dict:
    """Device ms and launches of each CLI_ROUTES route in one profiled
    request, and the request's whole device time (the kernel table in
    ``out_name``)."""
    split = _step_split(prof, out_name, CLI_ROUTES)
    return {"device_ms": split["device_ms"], "device_launches": split["device_launches"],
            "routes": {k: {"ms": split[f"{k}_ms"], "launches": split[f"{k}_launches"]}
                       for k in CLI_ROUTES}}


def _cli_bounds(gen, P: int, T: int) -> dict:
    """Each route's least time for one request of phone bucket P and frame
    bucket T, B = 1, summed over its launches, as its PERF.md row counts
    it: ffn_ln per FFT block (the duration pass's encoder, the full pass's
    encoder and decoder; f32 products at split TF32's 165 TFLOP/s), the
    resblock launches of one vocoder call, lvc_stack per routed stage and ε
    pass; and the launches that sum covers."""
    from lightningfastspeech2_tpu_torch.ops.fastdiff_lvc import routes_to_kernel
    from lightningfastspeech2_tpu_torch.synthesis.generator import FastDiffSynthesiser

    out = {}

    def add(route, flops, nbytes, dtype, peak):
        b, by = bound_ms(flops, nbytes, dtype, peak)
        r = out.setdefault(route, {"bound_ms": 0.0, "bound_launches": 0, "bound_by": by})
        r["bound_ms"] += b
        r["bound_launches"] += 1

    m = gen.model
    blocks = [(b, P) for b in m.encoder.layers] * 2 + [(b, T) for b in m.decoder.layers]
    for blk, L in blocks:
        w = blk.ffn_weights
        C, F = w.w1.shape
        f32 = m.dtype == torch.float32
        flops = L * (2 * w.kernel_size * C + 4 * C * F)
        nbytes = 2 * L * C * w.w1.element_size() + tensor_bytes(w.wd, w.w1, w.b1, w.w2f, w.lnp)
        add("ffn_ln_f32" if f32 else "ffn_ln_bf16", flops, nbytes, m.dtype,
            PEAK_F32_ACCURATE if f32 else None)
    synth = gen.synthesiser
    if isinstance(synth, FastDiffSynthesiser):
        v = synth.vocoder
        dt, C, layers = v.dtype, v.cfg.inner_channels, v.cfg.lvc_layers_each_block
        peak = PEAK_FLOPS[dt] if dt == torch.bfloat16 else PEAK_F32_ACCURATE
        elt = torch.finfo(dt).bits // 8
        hop = 1
        for r in v.cfg.upsample_ratios:
            hop *= r
            if not routes_to_kernel(hop, T, layers):
                continue
            L = T * hop
            flops = L * layers * 2 * (3 * C * C + 3 * C * 2 * C)
            # x in and out, the audio branch, the predicted kernels and biases,
            # the dilated convs' weights (f32 biases)
            nbytes = (3 * L * C + T * layers * (C * 2 * C * 3 + 2 * C) + layers * 3 * C * C) * elt \
                + layers * C * 4
            for _ in range(synth.n_steps):
                add("lvc_stack", flops, nbytes, dt, peak)
    elif synth is not None:
        g = synth.model
        dt = g.dtype
        route = "resblock_f32" if dt == torch.float32 else "resblock_bf16"
        L = T
        for stage, weights in enumerate(g.stage_weights):
            L *= g.cfg.upsample_rates[stage]
            for w in weights:
                C = w.channels
                convs = [(k, len(ds)) for k, ds in zip(w.kernel_sizes, w.dilations)]
                flops = L * sum(2 * k * C * C * 2 * n for k, n in convs)
                n_w = sum(k * C * C * 2 * n for k, n in convs)
                elt = torch.finfo(dt).bits // 8
                nbytes = 2 * L * C * elt + n_w * elt + tensor_bytes(w.bias)
                add(route, flops, nbytes, dt, PEAK_F32_ACCURATE if dt == torch.float32 else None)
    return out


def _cli_request(gen, cfg, args, name: str, smi: str) -> dict:
    """One CLI run's request through the generator the CLI builds: the host
    ms of ``generate_from_text`` (median of CLI_RUNS after one warm call),
    then one call under the profiler: device ms, and per route device ms,
    launches and bound at the request's buckets."""
    from torch.profiler import ProfilerActivity, profile

    from lightningfastspeech2_tpu_torch.cli import generate as cli

    mels = []
    synth = gen.synthesiser

    def recording(mel):   # the vocoder sees the mel at its frame bucket
        mels.append(np.shape(mel))
        return synth(mel)

    gen.synthesiser = recording
    cli.synthesize_sentence(gen, cfg, args)
    torch.cuda.synchronize()
    runs = []
    for _ in range(CLI_RUNS):
        t = time.perf_counter()
        wav = cli.synthesize_sentence(gen, cfg, args)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cli.synthesize_sentence(gen, cfg, args)
        torch.cuda.synchronize()
    gen.synthesiser = synth
    split = _route_split(prof, f"cli_{name}_profile.txt")
    n_ph = len(gen.text_to_ids(args.sentence))
    P, T = gen.bucketer.phone_bucket(n_ph), mels[-1][0]
    bounds = _cli_bounds(gen, P, T)
    routes = {}
    for k, r in split["routes"].items():
        if r["launches"] == 0:
            continue
        b = bounds.get(k, {})
        routes[k] = {**r, "ms_a_launch": r["ms"] / r["launches"], **b,
                     **({"x_bound": r["ms"] / b["bound_ms"]} if b else {})}
    return {"host_ms_median": statistics.median(runs), "host_ms_runs": runs,
            "device_ms": split["device_ms"], "device_launches": split["device_launches"],
            "phones": n_ph, "phone_bucket": P, "frame_bucket": T,
            "samples": int(wav.size), "routes": routes, "nvidia_smi": smi}


def cli_phase(counters, smi: str) -> dict:
    """Phase 17: the port's generate CLI on the card from checkpoints this
    phase writes: f32 HiFi-GAN V1 (the CLI's default), bf16 V1, with
    restoration and an augmentation, and FastDiff on the joint checkpoint,
    each with ``--prior_strategy gmm --sample_dvector`` on a sentence with an
    out-of-vocabulary word. Each wav must be finite, non-empty and at its
    rate; each run's routes must show their kernels; the f32 run's waveform
    must agree with the same CLI run on the CPU within phase 6's tolerance,
    and the neural G2P must spell the OOV word on the card as on the CPU."""
    import shutil

    from lightningfastspeech2_tpu_torch.cli import generate as cli
    from lightningfastspeech2_tpu_torch.data import wav as wav_io
    from lightningfastspeech2_tpu_torch.synthesis import neural_g2p

    work = ROOT / "_chip" / "cli_checkpoints"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    dirs = write_cli_checkpoints(work)
    emit({"phase": "cli_checkpoints", "seconds": time.perf_counter() - t0,
          "model": "lightspeech_flagship, priors pitch + energy, 2 d-vector speakers; "
                   "joint: + residual head and FastDiff (reference widths)"})
    out_root = ROOT / "chiprun_out" / "cli"
    runs = {  # name: (checkpoint, flags, routes that must launch, routes that must not)
        "f32": ("acoustic", [], ("ffn_ln_f32", "resblock_f32"), ("resblock_bf16",)),
        "bf16": ("acoustic", ["--vocoder_precision", "16"], ("ffn_ln_f32", "resblock_bf16"),
                 ("resblock_f32",)),
        "restore_augment": ("acoustic", ["--restore", "true", "--augment_gaussian_snr", "true"],
                            ("ffn_ln_f32", "resblock_f32"), ("resblock_bf16",)),
        "fastdiff": ("joint", ["--use_fastdiff", "true", "--fastdiff_n", "4"],
                     ("ffn_ln_f32", "lvc_stack"), ("resblock_f32", "resblock_bf16")),
    }
    rows = {}
    for name, (ckpt, flags, must, must_not) in runs.items():
        argv = ["--checkpoint_dir", dirs[ckpt], "--sentence", CLI_SENTENCE, "--seed", "0",
                "--prior_strategy", "gmm", "--sample_dvector",
                "--output_path", str(out_root / name), *flags]
        reset_counts(counters)
        t = time.perf_counter()
        wav = cli.main(argv)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        launches = {c.__name__: c.launches for c in counters if c.launches}
        written, sr = wav_io.read(out_root / name / "sentence.wav")
        want_sr = 44100 if "--restore" in flags else SAMPLING_RATE
        if not (written.size > 0 and np.isfinite(written).all() and sr == want_sr
                and np.isfinite(wav).all() and wav.size == written.size):
            raise RuntimeError(f"cli {name}: wav of {written.size} samples at {sr} Hz "
                               f"(want {want_sr}), finite={np.isfinite(written).all()}")
        args = cli.build_parser().parse_args(argv)
        gen, cfg, _ = cli.load_generator(args)
        chain = cli.postprocess_chain(args)
        if chain is not None:
            gen.set_postprocess(chain)
        req = _cli_request(gen, cfg, args, name, smi)
        row = {"phase": "cli", "run": name, "flags": flags, "main_s": main_s,
               "wav_samples": int(written.size), "sampling_rate": sr,
               "peak": float(np.abs(written).max()), "launches_main_run": launches, **req}
        emit(row)
        missing = [k for k in must if k not in req["routes"]]
        extra = [k for k in must_not if k in req["routes"]]
        if missing or extra:
            raise RuntimeError(f"cli {name}: routes {sorted(req['routes'])}, missing {missing}, "
                               f"unexpected {extra}")
        row["wav"], row["oov_phones"] = wav, gen.g2p.neural([CLI_OOV])[0]
        rows[name] = row
    # the plain path: the f32 run again with --device cpu
    argv = ["--checkpoint_dir", dirs["acoustic"], "--sentence", CLI_SENTENCE, "--seed", "0",
            "--prior_strategy", "gmm", "--sample_dvector",
            "--output_path", str(out_root / "f32_cpu"), "--device", "cpu"]
    t = time.perf_counter()
    ref = cli.main(argv)
    cpu_s = time.perf_counter() - t
    cpu_phones = neural_g2p.NeuralG2P.load(device="cpu")([CLI_OOV])[0]
    a = rows["f32"]["wav"]
    top = float(np.abs(ref).max())
    err = float(np.abs(a - ref).max()) if a.shape == ref.shape else float("inf")
    tol = 1e-3 * top + 1e-7   # phase 6's
    emit({"phase": "cli_reference", "samples": [a.size, ref.size], "max_abs_err": err,
          "tol": tol, "peak": top, "cpu_main_s": cpu_s, "oov": CLI_OOV,
          "oov_phones": {n: r["oov_phones"] for n, r in rows.items()} | {"cpu": cpu_phones},
          "nvidia_smi": smi})
    if not (a.shape == ref.shape and err <= tol and top > 0):
        raise RuntimeError(f"cli f32 card vs CPU: shapes {a.shape} {ref.shape}, "
                           f"max |err| {err} > {tol}")
    if not cpu_phones or any(r["oov_phones"] != cpu_phones for r in rows.values()):
        raise RuntimeError(f"neural G2P on the card {[r['oov_phones'] for r in rows.values()]} "
                           f"against the CPU's {cpu_phones}")
    shutil.rmtree(work, ignore_errors=True)
    # each route alone at the request's shapes (B = 1, its buckets) against
    # its plain version, as phases 4 and 14 hold them at theirs
    dev, g = torch.device("cuda", 0), torch.Generator().manual_seed(17)
    P, T = rows["f32"]["phone_bucket"], rows["f32"]["frame_bucket"]
    f32 = torch.float32
    served = {"ffn_ln_f32": [_ffn_case(dev, 1, P, 5, f32, g), _ffn_case(dev, 1, T, 17, f32, g)],
              "resblock_f32": _resblock_cases(dev, T, g, f32),
              "resblock_bf16": _resblock_cases(dev, T, g),
              "lvc_stack_f32": [_lvc_case(dev, g, hop, f32, nL=T) for hop in (64, 256)]}
    emit({"phase": "cli_served_shapes", "phone_bucket": P, "frame_bucket": T,
          **{k: [{f: r[f] for f in ("at", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "max_abs_err")} for r in v] for k, v in served.items()},
          "nvidia_smi": smi})
    return {n: {k: v for k, v in r.items() if k != "wav"} for n, r in rows.items()}


# ------------------------------------------- the other presets (phases 18-23)
# (B, T, C, k) of ffn_wide_kernel's cases: lightspeech_true76m's request
# and batch shapes at its narrowest, middle and widest depthwise kernel,
# C = 384 and 512 at the batch's shape, and an encoder launch at a
# sentence's phone count; F = 4 C
WIDE_FFN_SHAPES = ([(1, 256, 640, k) for k in (5, 17, 25)]
                   + [(8, 512, 640, k) for k in (5, 17, 25)]
                   + [(8, 512, 384, 17), (8, 512, 512, 17), (1, 32, 640, 5)])
# (B, H, T, head_dim) of the flash cases past head dim 128
WIDE_FLASH_SHAPES = ((2, 2, 2048, 256), (1, 1, 1024, 512))


def wide_kernels_phase(dev) -> dict:
    """Phases 18-19: ``ffn_ln`` at C = 384-640 (``ffn_wide_kernel``) in
    both dtypes against ``ffn_ln_plain``, each launch as the library
    recorded it against ``ffn_plan``; flash attention at head dims 256 (the
    tensor-core routes' D = 256 templates) and 512 (the CUDA-core route),
    forward and backward, both dtypes, against the plain version with SDPA
    beside it."""
    g = torch.Generator().manual_seed(16)
    ffn = {dt: [_ffn_case(dev, B, T, k, dt, g, C, 4 * C) for B, T, C, k in WIDE_FFN_SHAPES]
           for dt in (torch.bfloat16, torch.float32)}
    flash = {(d, dt): _flash_case(dev, g, dt, B, T, 0.1, H, d)
             for B, H, T, d in WIDE_FLASH_SHAPES for dt in (torch.bfloat16, torch.float32)}
    return {"ffn": ffn, "flash": flash}


def _preset_launches(counters, gen, cfg, run, tag) -> dict:
    """A served preset's launches against what its path launches: per
    generate_samples call ``ffn_ln`` in every fused block of the duration
    pass (the encoder) and the full pass (encoder and decoder), per vocoder
    call one resblock or trio launch per prepared stack; ``by_width`` the
    ``ffn_ln`` launches by C."""
    from lightningfastspeech2_tpu_torch.ops.ffn import ffn_ln

    m = cfg.model
    fused = m.encoder.conformer and m.encoder.depthwise and m.hidden % 128 == 0
    launches = {c.__name__: c.launches for c in counters}
    stacks = gen.synthesiser.model.stage_weights
    n_items = len(run["vocoder_buckets"])
    want = {c.__name__: 0 for c in counters}
    want.update(probe=launches["probe"],  # once a process, when the card is first resolved
                ffn_ln=run["n_calls"] * (2 * m.encoder.layers + m.decoder.layers) * fused,
                resblock=n_items * sum(len(s) for s in stacks if len(s) > 1),
                resblock_trio=n_items * sum(1 for s in stacks if len(s) == 1))
    widths = dict(ffn_ln.by_width)
    want_widths = {m.hidden: want["ffn_ln"]} if want["ffn_ln"] else {}
    emit({"phase": f"{tag}launches", **launches, "expected": want, "ffn_ln_by_width": widths})
    if launches != want or widths != want_widths:
        raise RuntimeError(f"{tag} launches {launches} (by width {widths}), expected {want} "
                           f"({want_widths})")
    return launches


def ffn_device_split(fn, out_name: str) -> dict:
    """``fn`` once under torch.profiler: the device ms and kernels of every
    kernel and of the wide ``ffn_ln`` launches (ffn_wide_kernel and its LN2
    pass); the kernel table in chiprun_out/``out_name``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = _step_split(prof, out_name, {"ffn_ln_wide": STEP_FAMILIES["ffn_ln_wide"]})
    return {"device_ms": split["device_ms"], "device_launches": split["device_launches"],
            "ffn_ln_ms": split["ffn_ln_wide_ms"], "ffn_ln_kernels": split["ffn_ln_wide_launches"]}


def true76m_serving_phase(counters, served) -> dict:
    """Phase 20: lightspeech_true76m (hidden 640, filter 2560, 8 + 7
    blocks) with HiFi-GAN V1 from seeded generators serves phase 5's
    sentences and a batch of 8 at frame bucket 512, in bf16 and in f32; the
    counters, set to 0 just before each run, must show ``ffn_ln`` at C =
    640 in every block; after it, the longest request and the batch once
    more under torch.profiler for ``ffn_ln``'s device ms. Then one f32
    request on the card against the same request on the CPU's plain path
    (phase 6's tolerance)."""
    from lightningfastspeech2_tpu_torch.core.config import lightspeech_true76m

    cfg, dvecs = lightspeech_true76m(), served["dvecs"]
    out, bias = {}, None
    for dtype in (torch.bfloat16, torch.float32):
        tag = f"true76m_{str(dtype)[6:]}_"
        t0 = time.perf_counter()
        # the duration bias taken on the card before the counts (bf16 run)
        gen, bias = _make_generator(cfg, dtype, None, dvecs, BATCH_TEXTS, bias)
        setup_s = time.perf_counter() - t0
        reset_counts(counters)
        run = _serve_all(gen, cfg, dvecs, tag)
        launches = _preset_launches(counters, gen, cfg, run, tag)
        # after the counted run: ffn_ln's device time in the longest request
        # and in the batch, from torch.profiler
        dt = str(dtype)[6:]
        device = {"request": ffn_device_split(
                      lambda: gen.generate_from_text(SENTENCES[-1], speaker="spk0", seed=0),
                      f"true76m_{dt}_request_profile.txt"),
                  "batch": ffn_device_split(lambda: gen.generate_samples(run["batch_inputs"]),
                                            f"true76m_{dt}_batch_profile.txt")}
        emit({"phase": f"{tag}ffn_ln_device", **device})
        out[dt] = {"setup_s": setup_s, "launches": launches, "batch": run["batch"],
                   "request_ms": [r["ms"] for r in run["requests"]], "ffn_ln_device": device}
        del gen
    reference_phase({"cfg": cfg, "dvecs": dvecs, "bias": bias}, tag="true76m_")
    return out


def true76m_training_phase(counters) -> dict:
    """Phase 21: lightspeech_true76m in bf16 with f32 parameters and bf16
    Adam moments takes 1 warm-up and 3 timed steps at B=8, P=256, T=2048
    (config dropout rates): finite losses, a finite non-zero gradient on
    every parameter; the counters, set to 0 just before, must show every
    decoder flash launch through the wgmma kernels (head dim 128) and no
    ``ffn_ln_train`` launch (the JAX gate's fit estimate sends (640, 2560)
    to the unfused FFN). One more step under the profiler gives the time
    split, with the optimizer's share of it (``optimizer_split``)."""
    from lightningfastspeech2_tpu_torch.core.config import lightspeech_true76m, replace
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.train.optim import AdamWBf16Mu
    from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step
    from torch.profiler import ProfilerActivity, profile

    cfg = lightspeech_true76m()
    cfg = replace(cfg, train=replace(cfg.train, bf16_moments=True),
                  model=replace(cfg.model, max_phones=TRAIN_P, max_frames=TRAIN_T))
    batch = train_batch(cfg)
    n_steps = 4
    reset_counts(counters)
    t0 = time.perf_counter()
    model = build_fastspeech2(cfg.model, dtype=torch.bfloat16, seed=0)
    state = create_train_state(model, cfg)
    if not isinstance(state.optimizer, AdamWBf16Mu):
        raise RuntimeError(f"bf16_moments built {type(state.optimizer).__name__}")
    step = make_train_step(model, cfg)
    gen = torch.Generator(device=model.device).manual_seed(5)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    steps, metrics = [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {c.__name__: c.launches for c in counters}
    routes = flash_routes(counters)
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.any()]
    finite = all(math.isfinite(v) for m in metrics for v in m.values())
    L_dec = cfg.model.decoder.layers
    want = {c.__name__: 0 for c in counters}
    want.update(flash_attention=n_steps * L_dec, flash_attention_bwd=n_steps * L_dec)
    mu_dtypes = {str(s["exp_avg"].dtype) for s in state.optimizer.state.values()}
    timed = steps[1:]
    n_params = sum(p.numel() for p in model.parameters())
    row = {"phase": "true76m_training", "params": n_params, "setup_s": setup_s,
           "steps": n_steps, "step_ms": steps, "timed_step_ms_mean": sum(timed) / len(timed),
           "frames_per_s": TRAIN_B * TRAIN_T / (sum(timed) / len(timed) / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "first_losses": metrics[0], "last_losses": metrics[-1], "finite": finite,
           "params_without_grad": bad, "launches": launches, "expected": want,
           "flash_routes": routes, "flash_head_dims": flash_head_dims(counters),
           "first_moment_dtypes": sorted(mu_dtypes)}
    emit(row)
    if not finite or bad or mu_dtypes != {"torch.bfloat16"}:
        raise RuntimeError(f"true76m training: finite={finite}, params without gradient "
                           f"{bad[:8]}, first moments {mu_dtypes}")
    want_routes = {k: {**dict.fromkeys(v, 0), "flash_attention_sm90": want[k]}
                   for k, v in routes.items()}
    if launches != want or routes != want_routes:
        raise RuntimeError(f"true76m training launches {launches} ({routes}), expected {want}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
    split = _step_split(prof, "true76m_training_profile.txt")
    opt = optimizer_split(prof, state.optimizer)
    emit({"phase": "true76m_training_profile", **split, "optimizer": opt})
    return {"row": row, "split": split, "optimizer": opt}


def optimizer_split(prof, optimizer, calls: int = 5) -> dict:
    """The optimizer's share of a profiled step: the host ms and the device
    span of torch's ``Optimizer.step#...`` range in that step's trace; then
    ``optimizer.step()`` alone, outside the step (the step's gradients are
    still there): its device kernels a call and their device ms
    (``device_kernels``), and its host-clock ms a call over ``calls`` calls
    with one synchronise each."""
    from torch.autograd import DeviceType

    mark = f"Optimizer.step#{type(optimizer).__name__}.step"
    events = {(e.key, e.device_type): e for e in prof.key_averages() if e.key == mark}
    host = events.get((mark, DeviceType.CPU))
    span = events.get((mark, DeviceType.CUDA))
    alone = device_kernels(optimizer.step, calls)
    runs = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t = time.perf_counter()
        optimizer.step()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t) * 1e3)
    return {"range": mark,
            "in_step_host_ms": host.cpu_time_total / 1e3 if host else None,
            "in_step_device_span_ms": span.device_time_total / 1e3 if span else None,
            "alone_device_ms": alone["device_ms"], "alone_kernels": alone["kernels"],
            "alone_host_ms": statistics.median(runs), "alone_host_ms_runs": runs,
            "parameters": sum(len(g["params"]) for g in optimizer.param_groups)}


# (heads, head dim) at hidden 512: the two head dims past 128 that flash_ok
# admits and no preset has
HEAD_DIM_CASES = ((2, 256), (1, 512))


def head_dim_training_phase(counters) -> dict:
    """Phase 24: head dims past 128 through the train step (a config that
    ``flash_ok`` admits at head dim 256 used to raise on the card): the
    flagship at hidden 512 (filter 2048, so the JAX gate's fit estimate
    sends the FFN to the unfused path) with 2 heads (head dim 256) and 1
    (head dim 512), one encoder and one decoder block, one step in bf16 and
    one in f32 parameters and activations at B=2, P=128, T=1024. The
    counters, set to 0 just before each step, must show one forward and one
    backward flash launch, the decoder block's, at that route and head dim;
    losses and gradients finite."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.ops import attention as att
    from lightningfastspeech2_tpu_torch.core.config import replace
    from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step

    B_P_T = (2, 128, 1024)
    rows = []
    for heads, d in HEAD_DIM_CASES:
        cfg = train_config(B_P_T=B_P_T)
        m = cfg.model
        stack = dict(hidden=512, heads=heads, layers=1, conv_filter_size=2048)
        m = replace(m, encoder=replace(m.encoder, kernel_sizes=m.encoder.kernel_sizes[:1], **stack),
                    decoder=replace(m.decoder, kernel_sizes=m.decoder.kernel_sizes[:1], **stack))
        cfg = replace(cfg, model=m)
        batch = train_batch(cfg, B_P_T)
        for dtype in (torch.bfloat16, torch.float32):
            model = build_fastspeech2(cfg.model, dtype=dtype, seed=0)
            state = create_train_state(model, cfg)
            step = make_train_step(model, cfg)
            reset_counts(counters)
            t = time.perf_counter()
            state, metrics = step(state, batch, torch.Generator(device=model.device).manual_seed(4))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            launches = {c.__name__: c.launches for c in counters if c.launches}
            dims = flash_head_dims(counters)
            losses = {k: float(v) for k, v in metrics.items()}
            bad = [n for n, p in model.named_parameters()
                   if p.grad is None or not torch.isfinite(p.grad).all()]
            route = (att.ROUTES if d in att.TENSOR_CORE_DIMS else att.WIDE_ROUTES)[dtype]
            want = {"flash_attention": {f"{route} d={d}": 1},
                    "flash_attention_bwd": {f"{route} d={d}": 1}}
            row = {"phase": "head_dim_training", "head_dim": d, "heads": heads,
                   "dtype": str(dtype)[6:], "at": f"hidden 512, 1 + 1 blocks, B=2, P=128, T=1024",
                   "step_ms_first": ms, "losses": losses, "launches": launches,
                   "flash_head_dims": dims, "expected_flash_head_dims": want,
                   "params_without_finite_grad": bad}
            emit(row)
            if (dims != want or bad or not all(math.isfinite(v) for v in losses.values())
                    or launches.get("ffn_ln_train", 0)):
                raise RuntimeError(f"head dim {d} training step: {row}")
            rows.append(row)
    return {"rows": rows}


# HiFi-GAN V3's published config, the released vocoder with ResBlock2
HIFIGAN_RESBLOCK2 = dict(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                         upsample_initial_channel=256, resblock_kernel_sizes=(3, 5, 7),
                         resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))


def fastspeech2_27m_phase(counters, served, smi: str) -> dict:
    """Phase 22: fastspeech2_27m (plain ConvFFN blocks, no speaker
    embedding) with HiFi-GAN V1 in bf16 serves phase 5's sentences and
    batch; its blocks run the unfused FFN, so the counters show no
    ``ffn_ln`` launch. Then ``cli.generate.main`` serves a sentence from a
    port checkpoint of it with a ResBlock2 vocoder directory (HiFi-GAN V3's
    dims, plain convs: no resblock kernel launch), f32."""
    import shutil

    from lightningfastspeech2_tpu_torch.cli import generate as cli
    from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer
    from lightningfastspeech2_tpu_torch.core.config import fastspeech2_27m, replace
    from lightningfastspeech2_tpu_torch.data import wav as wav_io
    from lightningfastspeech2_tpu_torch.data.vocab import ARPABET_TO_IPA, PUNCTUATION_TOKENS, SILENCE
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import HifiGanConfig, Synthesiser

    cfg, dvecs = fastspeech2_27m(), served["dvecs"]
    gen, _ = _make_generator(cfg, torch.bfloat16, None, dvecs, BATCH_TEXTS, None)
    reset_counts(counters)
    run = _serve_all(gen, cfg, dvecs, "fs27m_")
    launches = _preset_launches(counters, gen, cfg, run, "fs27m_")
    del gen

    work = ROOT / "_chip" / "fs27m_checkpoints"
    shutil.rmtree(work, ignore_errors=True)
    phones = sorted(set(ARPABET_TO_IPA.values()) | set(PUNCTUATION_TOKENS.values()) | {SILENCE})
    phone2id = {"[PAD]": 0, **{p: i + 1 for i, p in enumerate(phones)}}
    cfg = replace(cfg, model=replace(cfg.model, vocab_size=len(phone2id)))
    model = build_fastspeech2(cfg.model, device="cpu", seed=0)
    with torch.no_grad():
        head = model.variance_adaptor.duration_predictor.linear
        head.weight.zero_()
        head.bias.fill_(math.log(8.0))   # 7 frames a phone
    stats = {v: {"min": -2.0, "max": 3.0, "mean": 0.0, "std": 1.0}
             for v in cfg.model.variance.variances}
    Checkpointer(work / "ckpt").save(1, model.state_dict(), cfg,
                                     {"phone2id": phone2id, "stats": stats})
    vcfg = HifiGanConfig(**HIFIGAN_RESBLOCK2)
    voc = Synthesiser(vcfg, device="cpu", seed=2).model
    Checkpointer(work / "voc").save(1, {"gen": voc.state_dict()},
                                    sidecar={"hifigan_config": dataclasses.asdict(vcfg)})
    out_dir = ROOT / "chiprun_out" / "cli_fs27m"
    argv = ["--checkpoint_dir", str(work / "ckpt"), "--hifigan_checkpoint", str(work / "voc"),
            "--sentence", CLI_SENTENCE, "--seed", "0", "--output_path", str(out_dir)]
    reset_counts(counters)
    t = time.perf_counter()
    wav = cli.main(argv)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t
    cli_launches = {c.__name__: c.launches for c in counters
                    if c.launches and c.__name__ != "probe"}
    written, sr = wav_io.read(out_dir / "sentence.wav")
    row = {"phase": "fs27m_cli", "main_s": main_s, "wav_samples": int(written.size),
           "sampling_rate": sr, "peak": float(np.abs(written).max()),
           "vocoder": "ResBlock2 (HiFi-GAN V3 dims), f32", "launches": cli_launches,
           "nvidia_smi": smi}
    emit(row)
    if not (written.size > 0 and np.isfinite(written).all() and sr == SAMPLING_RATE
            and np.isfinite(wav).all()):
        raise RuntimeError(f"fastspeech2_27m CLI: {written.size} samples at {sr} Hz")
    if any(k in cli_launches for k in ("ffn_ln", "resblock", "resblock_trio")):
        raise RuntimeError(f"fastspeech2_27m CLI launched {cli_launches}: its convs are plain")
    shutil.rmtree(work, ignore_errors=True)
    return {"launches": launches, "batch": run["batch"], "cli": row}


def every_layer_phase(counters, served) -> dict:
    """Phase 23: the flagship with every-layer speaker and prior embeddings
    (pitch and energy priors) in bf16: one request through
    ``generate_from_text`` (``ffn_ln`` in every block) and one training
    step at B=2, P=64, T=1024 (``ffn_ln_train`` in every block, flash in
    every decoder block), finite throughout."""
    from lightningfastspeech2_tpu_torch.core.config import lightspeech_flagship, replace
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2, make_dummy_batch
    from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step

    cfg = lightspeech_flagship()
    cfg = replace(cfg, model=replace(cfg.model, priors=("pitch", "energy"),
                                     speaker_embedding_every_layer=True,
                                     prior_embedding_every_layer=True))
    m = cfg.model
    gen, _ = _make_generator(cfg, torch.bfloat16, None, served["dvecs"], BATCH_TEXTS,
                             served["bias"])
    reset_counts(counters)
    wav = gen.generate_from_text(SENTENCES[1], speaker="spk0", seed=0)
    torch.cuda.synchronize()
    served_launches = {c.__name__: c.launches for c in counters
                       if c.launches and c.__name__ != "probe"}
    tcfg = replace(cfg, model=replace(m, max_phones=64, max_frames=1024))
    batch = make_dummy_batch(tcfg.model, batch_size=2, n_phones=48, n_frames=1024, seed=0,
                             fill_frames=True)
    model = build_fastspeech2(tcfg.model, dtype=torch.bfloat16, seed=0)
    state = create_train_state(model, tcfg)
    reset_counts(counters)
    state, metrics = make_train_step(model, tcfg)(
        state, batch, torch.Generator(device=model.device).manual_seed(3))
    torch.cuda.synchronize()
    train_launches = {c.__name__: c.launches for c in counters
                      if c.launches and c.__name__ != "probe"}
    losses = {k: float(v) for k, v in metrics.items()}
    L = m.encoder.layers + m.decoder.layers
    row = {"phase": "every_layer", "request_samples": int(wav.size),
           "request_finite": bool(np.isfinite(wav).all()), "request_launches": served_launches,
           "train_losses": losses, "train_launches": train_launches}
    emit(row)
    want_train = {"ffn_ln_train": L, "ffn_ln_train_bwd": L,
                  "flash_attention": m.decoder.layers, "flash_attention_bwd": m.decoder.layers}
    if not (wav.size > 0 and np.isfinite(wav).all() and served_launches.get("ffn_ln", 0) >= L
            and all(math.isfinite(v) for v in losses.values()) and train_launches == want_train):
        raise RuntimeError(f"every-layer embeddings: {row}")
    return row


# ------------------------------------------------ the data pipeline (phase 25)
# a synthetic corpus for the dataset phase: make_rich_corpus speakers x
# utterances (no real speech is in the repository)
DS_SPEAKERS, DS_UTTS = 4, 8
# the flagship's variances and priors; no duration augmentation, so that the
# loader's workers make the items the synchronous order makes
DS_CONFIG = dict(variances=("pitch", "energy", "snr"), variance_levels=("frame",) * 3,
                 variance_transforms=("cwt", "none", "none"), priors=("pitch", "energy"),
                 augment_duration=0.0)
DS_BATCH = 4
# tests/test_torch_audio.py's margin on d' around YIN's decisions
YIN_MARGIN = 1e-3


def _hold_features(fa, fb, wav, audio, frames) -> dict:
    """One utterance's frame features from two devices (``TTSDataset
    _extract``) held to the CPU tests' tolerances (tests/test_torch_audio.py):
    mel, energy and SNR within their rounding bounds, pitch off the frames
    near a YIN decision. Returns the errors, the bounds, the frames near a
    decision and whether any decision came out otherwise."""
    from lightningfastspeech2_tpu_torch.audio import pitch as pitch_mod
    from lightningfastspeech2_tpu_torch.audio.features import energy_rounding_bound
    from lightningfastspeech2_tpu_torch.audio.snr import snr_rounding_bound

    win = audio.win_length
    lin_a, lin_b = 10.0 ** fa["mel"].astype(np.float64), 10.0 ** fb["mel"].astype(np.float64)
    peak = lin_b.max()
    loud = lin_b >= 1e-3 * peak
    mel_lin = float(np.abs(lin_a - lin_b).max() / peak)
    mel_log = float(np.abs(fa["mel"] - fb["mel"])[loud].max())
    e_err = float(np.abs(fa["energy"].astype(np.float64) ** 2
                         - fb["energy"].astype(np.float64) ** 2).max())
    e_bound = energy_rounding_bound(wav, win)
    nan_a, nan_b = np.isnan(fa["snr"]), np.isnan(fb["snr"])
    ok = ~nan_b
    snr_err = float(np.abs(fa["snr"][ok] - fb["snr"][ok]).max()) if ok.any() else 0.0
    snr_tol = snr_rounding_bound(wav, fb["snr"][ok], win) if ok.any() else 0.0
    near = pitch_mod.near_decision(frames, audio.sampling_rate, YIN_MARGIN).numpy()[
        : len(fb["pitch"])]
    pa, pb = fa["pitch"], fb["pitch"]
    keep = ~near
    voiced = keep & (pb > 0)
    f0_rel = float((np.abs(pa - pb)[voiced] / pb[voiced]).max()) if voiced.any() else 0.0
    changed = bool(((pa > 0) != (pb > 0)).any()
                   or (np.abs(pa - pb) > 1e-5 * np.maximum(pb, 1.0)).any())
    out = {"mel_lin_err": mel_lin, "mel_log_err": mel_log, "energy_sq_err": e_err,
           "energy_sq_bound": e_bound, "snr_err_db": snr_err, "snr_tol_db": snr_tol,
           "f0_rel_err": f0_rel, "near_decision_frames": int(near.sum()),
           "decision_changed": changed}
    fails = [k for k, bad in (
        ("mel", mel_lin > 2e-6 or mel_log > 1e-4),
        ("energy", e_err > e_bound),
        ("snr", not np.array_equal(nan_a, nan_b) or snr_err > snr_tol),
        ("pitch", not np.array_equal(pa[keep] > 0, pb[keep] > 0) or f0_rel > 1e-5)) if bad]
    if fails:
        raise RuntimeError(f"dataset features card vs CPU: {fails} {out}")
    return out


def _hold_item(a, b, wav, stats_a, stats_b, win, pitch_too: bool) -> None:
    """One item from two devices, key for key, at the CPU tests' item
    tolerances (tests/test_torch_dataset.py); the pitch keys only where no
    YIN decision came out otherwise. Each dataset z-normalizes with its own
    stats, so energy and SNR are held de-normalized, and the energy prior
    (a mean of energies) within the largest frame's energy bound."""
    from lightningfastspeech2_tpu_torch.audio.features import (energy_error_bound,
                                                               energy_rounding_bound)
    from lightningfastspeech2_tpu_torch.audio.snr import snr_rounding_bound

    if set(a) != set(b):
        raise RuntimeError(f"item keys differ: {set(a) ^ set(b)}")

    def plain(item, stats, var):   # a normalized variance back in its units
        st = stats[var]
        return np.asarray(item[f"variances_{var}"], np.float64) * st["std"] + st["mean"]

    ea, eb = plain(a, stats_a, "energy"), plain(b, stats_b, "energy")
    e_bound = energy_rounding_bound(wav, win)
    bad = []
    for k, y in b.items():
        x = a[k]
        if isinstance(y, str):
            bad += [k] if x != y else []
            continue
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != y.dtype or x.shape != y.shape:
            bad.append(k)
        elif y.dtype.kind in "biu" or k in ("speaker", "utterance_dvec"):
            bad += [k] if not np.array_equal(x, y) else []
        elif k == "mel":
            la, lb = 10.0 ** x.astype(np.float64), 10.0 ** y.astype(np.float64)
            loud = lb >= 1e-3 * lb.max()
            bad += [k] if (np.abs(la - lb).max() > 2e-6 * lb.max()
                           or np.abs(x - y)[loud].max() > 1e-4) else []
        elif k.startswith("variances_pitch") or k == "priors_pitch":
            if not pitch_too:
                continue
            tol = {"variances_pitch_signal": (1e-5, 0), "priors_pitch": (1e-5, 0),
                   "variances_pitch_spectrogram": (0, 1e-6)}.get(k, (1e-6, 0))
            bad += [k] if not np.allclose(x, y, rtol=tol[0], atol=tol[1]) else []
        elif k == "priors_energy":
            err, tol = abs(float(x) - float(y)), energy_error_bound(ea, eb, e_bound).max()
            bad += [f"{k}: {err} > {tol}"] if err > tol else []
        elif k == "variances_energy":
            err = np.abs(ea ** 2 - eb ** 2).max()
            bad += [f"{k}: {err} > {e_bound}"] if err > e_bound else []
        elif k == "variances_snr":
            sa, sb = plain(a, stats_a, "snr"), plain(b, stats_b, "snr")
            err, tol = np.abs(sa - sb).max(), snr_rounding_bound(wav, sb, win)
            bad += [f"{k}: {err} > {tol}"] if err > tol else []
        else:
            bad.append(k)
    if bad:
        raise RuntimeError(f"item {b['id']} card vs CPU: {bad}")


def _hold_batch(batch, ref, feats, stats) -> None:
    """A loader batch against the same indices collated in the main process,
    both on the card: integer keys (phones, durations, lengths: the order)
    equal; the floats at the items' tolerances, since the card's prefix sums
    (CUB scans) may add in another order on each run: energy and SNR
    de-normalized within the batch's largest bounds, the rest rtol 1e-5 with
    a floor of 1e-6."""
    e_bound = max(f["energy_sq_bound"] for f in feats)
    snr_tol = max(f["snr_tol_db"] for f in feats)
    for k, v in ref.items():
        x = batch[k]
        if x.dtype != v.dtype or x.shape != v.shape:
            raise RuntimeError(f"loader batch key {k} differs in dtype or shape")
        if v.dtype.kind in "biu":
            ok = np.array_equal(x, v)
        elif k in ("variances_energy", "variances_snr"):
            st = stats[k.split("_")[1]]
            a, b = (np.asarray(y, np.float64) * st["std"] + st["mean"] for y in (x, v))
            ok = (np.abs(a - b).max() <= snr_tol if k == "variances_snr"
                  else np.abs(a ** 2 - b ** 2).max() <= e_bound)
        elif k == "priors_energy":   # a mean of energies, in its own units
            ok = np.abs(x.astype(np.float64) - v).max() <= math.sqrt(e_bound)
        elif k == "mel":
            la, lb = 10.0 ** x.astype(np.float64), 10.0 ** v.astype(np.float64)
            loud = lb >= 1e-3 * lb.max()
            ok = (np.abs(la - lb).max() <= 2e-6 * lb.max()
                  and np.abs(x - v)[loud].max() <= 1e-4)
        else:
            ok = np.allclose(x, v, rtol=1e-5, atol=1e-6, equal_nan=True)
        if not ok:
            raise RuntimeError(f"loader batch key {k} differs from the synchronous order's")


def _hold_stats(sa, sb, e_tol: float, snr_tol: float, pitch_too: bool) -> dict:
    """The corpus stats from two devices at the CPU tests' tolerances: each
    of min, max, mean and std moves at most by the largest frame's (or
    utterance prior's) error, so energy and its prior within ``e_tol``, SNR
    within ``snr_tol``, the rest rtol 1e-5 with a floor of 1e-6."""
    if set(sa) != set(sb):
        raise RuntimeError(f"stats keys differ: {set(sa) ^ set(sb)}")
    worst = {}
    for key, ref in sb.items():
        if key in ("pitch", "priors_pitch") and not pitch_too:
            continue
        for s, v in ref.items():
            err = abs(sa[key][s] - v)
            tol = {"energy": e_tol, "priors_energy": e_tol, "snr": snr_tol}.get(
                key, 1e-5 * abs(v) + 1e-6)
            worst[key] = max(worst.get(key, 0.0), err)
            if err > tol:
                raise RuntimeError(f"stats {key}.{s} card {sa[key][s]} CPU {v} (tol {tol})")
    return worst


def dataset_phase(counters, smi: str) -> dict:
    """Phase 25: the data pipeline on the card. A make_rich_corpus corpus
    under ``_chip/``; ``TTSDataset`` on the card with the flagship's
    variances (frame-level pitch with CWT, energy, SNR; pitch and energy
    priors, stats computed there) held item for item, stats and priors
    against the same dataset on the CPU; items a second, the device ms and
    kernels of one item's extraction; a 2-worker ``PrefetchLoader`` on the
    card against the synchronous order; then the generate CLI's
    ``--dataset`` mode from phase 17's flagship checkpoint with f32
    HiFi-GAN V1, and one collated item served on the card against the CPU
    generator, and as int32 against its int64 twin."""
    import shutil

    from lightningfastspeech2_tpu_torch.audio import pitch as pitch_mod
    from lightningfastspeech2_tpu_torch.cli import generate as cli
    from lightningfastspeech2_tpu_torch.core.bucketing import round_up
    from lightningfastspeech2_tpu_torch.data import wav as wav_io
    from lightningfastspeech2_tpu_torch.data.dataset import DataConfig, TTSDataset
    from lightningfastspeech2_tpu_torch.data.loader import PrefetchLoader
    from lightningfastspeech2_tpu_torch.data.synthetic import make_rich_corpus
    from lightningfastspeech2_tpu_torch.ops.ffn import ffn_ln
    from lightningfastspeech2_tpu_torch.ops.hifigan_resblock import resblock, resblock_trio

    t_phase = time.perf_counter()
    work = ROOT / "_chip" / "dataset"
    shutil.rmtree(work, ignore_errors=True)
    t = time.perf_counter()
    corpus = make_rich_corpus(work / "corpus", n_speakers=DS_SPEAKERS, n_utts=DS_UTTS, seed=0)
    corpus_s = time.perf_counter() - t
    cfg = DataConfig(**DS_CONFIG)
    built, items = {}, {}
    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        ds = TTSDataset(corpus, cfg, device=dev)
        build_s = time.perf_counter() - t
        t = time.perf_counter()
        items[dev] = [ds.__getitem__(i, augment=False) for i in range(len(ds))]
        if dev == "cuda":
            torch.cuda.synchronize()
        built[dev] = {"ds": ds, "build_s": build_s, "items_s": time.perf_counter() - t}
    dc, dp = built["cuda"]["ds"], built["cpu"]["ds"]
    n = len(dc)
    audio = cfg.audio
    feats, changed = [], 0
    for i, e in enumerate(dp.entries):
        wav = dp._load_audio(e)
        bucket = round_up(max(len(wav), audio.hop_length), audio.hop_length * 256)
        padded = np.zeros(bucket, np.float32)
        padded[: len(wav)] = wav
        frames = pitch_mod.frame_windows(torch.from_numpy(padded), audio.sampling_rate,
                                         audio.hop_length, audio.win_length)
        f = _hold_features(dc._extract(wav), dp._extract(wav), wav, audio, frames)
        changed += f["decision_changed"]
        feats.append(f)
        _hold_item(items["cuda"][i], items["cpu"][i], wav, dc.stats, dp.stats,
                   audio.win_length, pitch_too=not f["decision_changed"])
    e_tol = math.sqrt(max(f["energy_sq_bound"] for f in feats))
    snr_tol = max(f["snr_tol_db"] for f in feats)
    stats_err = _hold_stats(dc.stats, dp.stats, e_tol, snr_tol, pitch_too=changed == 0)
    priors = {dev: built[dev]["ds"].create_priors() for dev in built}
    for spk, d in priors["cpu"].items():
        for var, ref in d.items():
            got = priors["cuda"][spk][var]
            ok = (np.allclose(got, ref, rtol=1e-5, atol=0) if var == "pitch"
                  else np.allclose(got, ref, rtol=0, atol=e_tol))
            if not ok and not (var == "pitch" and changed):
                raise RuntimeError(f"priors {spk}.{var} card {got} CPU {ref}")
    # one item's extraction: the median-length utterance
    mid = sorted(range(n), key=lambda i: len(items["cpu"][i]["mel"]))[n // 2]
    wav_mid = dc._load_audio(dc.entries[mid])
    one = device_kernels(lambda: dc._extract(wav_mid), calls=10)
    row = {"phase": "dataset", "corpus": f"make_rich_corpus {DS_SPEAKERS} x {DS_UTTS}, seed 0",
           "utterances": n, "frames": int(sum(len(it["mel"]) for it in items["cpu"])),
           "corpus_s": corpus_s,
           "build_with_stats_s": {d: b["build_s"] for d, b in built.items()},
           "items_per_s": {d: n / b["items_s"] for d, b in built.items()},
           "one_item_extraction": {"frames": len(items["cpu"][mid]["mel"]),
                                   "device_ms": one["device_ms"],
                                   "device_kernels": one["kernels"], "by_name": one["by_name"]},
           "max_err": {k: max(f[k] for f in feats) for k in feats[0] if k.endswith("_err")},
           "near_decision_frames": sum(f["near_decision_frames"] for f in feats),
           "items_with_a_changed_yin_decision": changed, "stats_max_err": stats_err,
           "nvidia_smi": smi}
    emit(row)

    # the prefetch loader: 2 spawn workers extracting on the card
    loader = PrefetchLoader(dc, batch_size=DS_BATCH, seed=0, epochs=1, num_workers=2,
                            prefetch=4, device="cuda")
    order = list(loader.index_stream())
    t = time.perf_counter()
    stamps, got = [], []
    with loader:
        for batch in loader:
            stamps.append(time.perf_counter() - t)
            got.append(batch)
    if len(got) != len(order):
        raise RuntimeError(f"loader gave {len(got)} batches, the order has {len(order)}")
    exact = True
    for batch, idx in zip(got, order):
        ref = dc.collate([items["cuda"][i] for i in idx], loader.bucketer)
        if set(batch) != set(ref):
            raise RuntimeError(f"loader batch {idx} keys {set(batch) ^ set(ref)}")
        exact &= all(np.array_equal(batch[k], v, equal_nan=True) for k, v in ref.items())
        _hold_batch(batch, ref, [feats[i] for i in idx], dc.stats)
    emit({"phase": "dataset_loader", "workers": loader.num_workers, "batch_size": DS_BATCH,
          "batches": len(got), "first_batch_s": stamps[0],
          "batches_per_s_after_first": ((len(got) - 1) / (stamps[-1] - stamps[0])
                                        if len(got) > 1 else None),
          "batches_per_s_all": len(got) / stamps[-1], "bitwise_equal_to_sync": exact,
          "nvidia_smi": smi})

    # the generate CLI's --dataset mode from phase 17's flagship checkpoint
    dirs = write_cli_checkpoints(work / "ckpt")
    out = work / "resynthesized"
    argv = ["--checkpoint_dir", dirs["acoustic"], "--dataset", str(corpus), "--seed", "0",
            "--output_path", str(out)]
    reset_counts(counters)
    t = time.perf_counter()
    wavs = cli.main(argv)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t
    launches = {c.__name__: c.launches for c in counters if c.launches}
    if len(wavs) != n or not ffn_ln.launches or not (resblock.launches
                                                     + resblock_trio.launches):
        raise RuntimeError(f"cli --dataset: {len(wavs)} of {n} utterances, launches {launches}")
    by_id = {it["id"]: it for it in items["cpu"]}
    audio_s = 0.0
    for key, wav in wavs.items():
        written, sr = wav_io.read(out / f"{key}.wav")
        meta = pickle.loads((out / f"{key}.meta").read_bytes())
        ref = by_id[key.split("/")[1]]
        if not (written.size > 0 and np.isfinite(written).all() and sr == SAMPLING_RATE
                and np.isfinite(wav).all() and wav.size == written.size
                and np.array_equal(meta["phones"], ref["phones"])
                and np.array_equal(meta["durations"], ref["duration"])
                and (out / f"{key}_original.wav").exists()):
            raise RuntimeError(f"cli --dataset {key}: {written.size} samples at {sr} Hz, "
                               f"meta {meta}")
        audio_s += written.size / sr
    # one utterance's re-synthesis under the profiler (the generator loaded
    # and warmed first): its kernel routes
    from torch.profiler import ProfilerActivity, profile

    gens, one_utt = {}, argv[:-1] + [str(out) + "_one", "--hours", "1e-9"]
    for dev in ("cuda", "cpu"):
        gens[dev] = cli.load_generator(cli.build_parser().parse_args(argv + ["--device", dev]))
    args = cli.build_parser().parse_args(one_utt)
    cli.resynthesize_dataset(*gens["cuda"], args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cli.resynthesize_dataset(*gens["cuda"], args)
        torch.cuda.synchronize()
    routes = _route_split(prof, "cli_dataset_profile.txt")
    seen = {k for k, r in routes["routes"].items() if r["launches"]}
    if not {"ffn_ln_f32", "resblock_f32"} <= seen or "resblock_bf16" in seen:
        raise RuntimeError(f"cli --dataset routes {sorted(seen)}")
    # one collated item of the CPU dataset, served on the card and on the CPU
    item = items["cpu"][mid]
    batch = {k: v for k, v in dp.collate([item]).items() if isinstance(v, np.ndarray)}
    twin = {k: v.astype(np.int64) if v.dtype == np.int32 else v for k, v in batch.items()}
    gens = {dev: g[0] for dev, g in gens.items()}
    a = gens["cuda"].generate_samples(batch)[0]
    a64 = gens["cuda"].generate_samples(twin)[0]
    b = gens["cpu"].generate_samples(batch)[0]
    top = float(np.abs(b).max())
    err = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
    tol = 1e-3 * top + 1e-7   # phase 6's
    emit({"phase": "cli_dataset", "utterances": len(wavs), "audio_s": audio_s, "main_s": main_s,
          "launches_main_run": launches, "profiled_one_utterance": routes,
          "served_item": {"id": item["id"], "phones": int(len(item["phones"])),
                          "int32_phones": str(batch["phones"].dtype),
                          "max_abs_err_card_vs_cpu": err, "tol": tol, "peak": top,
                          "int32_equals_int64_twin": bool(np.array_equal(a, a64))},
          "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi})
    if not (a.shape == b.shape and err <= tol and top > 0):
        raise RuntimeError(f"cli --dataset item card vs CPU: max |err| {err} > {tol}")
    if not np.array_equal(a, a64):
        raise RuntimeError("an int32 batch served otherwise than its int64 twin")
    shutil.rmtree(work, ignore_errors=True)
    return row


# ------------------------------------------------------------- train CLI
TC_SPEAKERS, TC_UTTS = 4, 8            # the bf16 run's corpus
TC_WORDS = (6, 36)                     # words an utterance: 2-14 s, buckets to 1536
TC_LONG_WORDS = (26, 30)               # the f32 corpus: 9-12 s, frame bucket 1024
TC_VALID_WORDS = (2, 4)                # the validation set: 4 x 2 utterances of 1-2 s
TC_STEPS = 20
TC_LOSS_REL = 1e-4                     # phase 9's loss tolerance, card against CPU
TC_DVEC_ATOL = 5e-4                    # one d-vector, card against CPU (test_torch_dvector.py)


class _StampedLines:
    """A stdout that keeps each line with the seconds since ``t0`` at which
    it was written."""

    def __init__(self, t0: float):
        self.t0, self.lines, self._part = t0, [], ""

    def write(self, text: str) -> int:
        *done, self._part = (self._part + text).split("\n")
        now = time.perf_counter() - self.t0
        self.lines += [(now, line) for line in done]
        return len(text)

    def flush(self) -> None:
        pass


def _train_cli(cli, argv, counters) -> dict:
    """``cli.main(argv)`` with every launch count set to 0 just before and
    read just after, its stdout captured (and echoed) with each line's
    seconds since the start, and its seconds."""
    reset_counts(counters)
    t = time.perf_counter()
    out = _StampedLines(t)
    with contextlib.redirect_stdout(out):
        result = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    text = "\n".join(line for _, line in out.lines)
    print(text, flush=True)
    # where the run's host time went: each line but the per-step ones
    timeline = [[round(s, 3), line[:60]] for s, line in out.lines
                if not line.startswith("step ") or "eval/" in line or line.startswith("step 0:")]
    return {"result": result, "stdout": text, "s": seconds, "timeline": timeline,
            "launches": {c.__name__: c.launches for c in counters},
            "flash_routes": flash_routes(counters)}


def _metrics_lines(log_dir: Path) -> list:
    return [json.loads(l) for l in (log_dir / "metrics.jsonl").read_text().splitlines()]


def train_cli_phase(counters, smi: str) -> dict:
    """Phase 26: the port's train CLI on the card. A make_rich_corpus corpus
    of 4 speakers with utterances of 2-14 s (batches of 8 reach frame
    buckets of 1024 and more, so the decoder runs flash attention) under
    ``_chip/``; the CLI trains the flagship in bf16 for ``TC_STEPS`` steps
    through a 2-worker loader, with d-vectors and their GMMs, priors and
    their GMMs, SWA, evals on a short validation set and asynchronous
    checkpoints every 10 steps;
    then a warm start, a soft-DTW run with ``LFS2_PALLAS_LR=1``, an f32 run
    (rates 0, B=2, frame bucket 1024) on the card against the same run on
    the CPU through one feature cache, one d-vector card against CPU, and
    the generate CLI serving the bf16 run's checkpoint with the prior GMMs.
    Each run's launches are counted; one more step of the trained model is
    profiled."""
    import shutil

    from lightningfastspeech2_tpu_torch.cli import generate as gen_cli
    from lightningfastspeech2_tpu_torch.cli import train as cli
    from lightningfastspeech2_tpu_torch.core.bucketing import Bucketer
    from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer
    from lightningfastspeech2_tpu_torch.data import wav as wav_io
    from lightningfastspeech2_tpu_torch.data.dataset import DataConfig, TTSDataset
    from lightningfastspeech2_tpu_torch.data.dvector import DVectorPipeline
    from lightningfastspeech2_tpu_torch.data.synthetic import make_rich_corpus
    from lightningfastspeech2_tpu_torch.train.loop import batch_iterator, build_model
    from lightningfastspeech2_tpu_torch.train.step import make_train_step
    from lightningfastspeech2_tpu_torch.utils.log_gmm import load_gmms

    t_phase = time.perf_counter()
    work = ROOT / "_chip" / "train_cli"
    shutil.rmtree(work, ignore_errors=True)
    t = time.perf_counter()
    corpus = make_rich_corpus(work / "corpus", n_speakers=TC_SPEAKERS, n_utts=TC_UTTS, seed=0,
                              min_words=TC_WORDS[0], max_words=TC_WORDS[1])
    long_corpus = make_rich_corpus(work / "long", n_speakers=2, n_utts=2, seed=1,
                                   min_words=TC_LONG_WORDS[0], max_words=TC_LONG_WORDS[1])
    # short: each eval's mel metrics run on the host (soft-DTW over an
    # N x M x 80 distance cube an utterance)
    valid = make_rich_corpus(work / "valid", n_speakers=TC_SPEAKERS, n_utts=2, seed=2,
                             min_words=TC_VALID_WORDS[0], max_words=TC_VALID_WORDS[1])
    corpus_s = time.perf_counter() - t
    ck, logs = work / "ckpt", work / "logs"
    base = ["--train_target_path", str(corpus), "--checkpoint_dir", str(ck),
            "--log_dir", str(logs), "--batch_size", "8", "--log_every", "1",
            "--cache_path", str(work / "cache"), "--priors", "pitch", "energy", "duration",
            "--variance_transforms", "cwt", "none", "none"]

    # the bf16 run: the flagship's widths, variances (pitch with CWT) and
    # d-vector speakers, the CLI's defaults otherwise
    argv = base + ["--valid_target_path", str(valid), "--max_steps", str(TC_STEPS),
                   "--eval_every", "10", "--checkpoint_every", "10", "--num_workers", "2",
                   "--dvector_gmm", "True", "--priors_gmm", "True", "--swa", "True"]
    run = _train_cli(cli, argv, counters)
    res = run["result"]
    lines = _metrics_lines(logs)
    train_lines = [l for l in lines if "train/total_loss" in l]
    eval_lines = [l for l in lines if "eval/mel_loss" in l]
    bad = [(l["step"], k) for l in lines for k, v in l.items()
           if k.startswith(("train/", "eval/")) and not math.isfinite(v)]
    if len(train_lines) != TC_STEPS or len(eval_lines) != 3 or bad:
        raise RuntimeError(f"train CLI: {len(train_lines)} step lines, {len(eval_lines)} evals, "
                           f"not finite {bad[:8]}")
    latest = (ck / "latest").read_text()
    tree, cfg, side = Checkpointer(ck).restore()
    m = cfg.model
    ds = TTSDataset(corpus, DataConfig(variances=m.variance.variances,
                                       variance_levels=m.variance.levels,
                                       variance_transforms=m.variance.transforms,
                                       priors=m.priors),
                    stats=side["stats"], speaker2dvector=side["speaker2dvector"],
                    cache_dir=work / "cache", device="cuda")
    restored = build_model(cfg, ds, device="cuda")
    restored.load_state_dict(tree["params"])
    swa_ok = (ck / "swa" / "latest").exists() and bool(Checkpointer(ck / "swa").latest_path())
    gmms = {n: load_gmms(ck / f"{n}.pkl") for n in ("prior_gmms", "dvector_gmms")}
    if not (latest == f"step_{TC_STEPS:08d}" and tree["opt_state"]["state"] and swa_ok
            and all(len(g) == TC_SPEAKERS for g in gmms.values())
            and len(side.get("speaker2priors", {})) == TC_SPEAKERS):
        raise RuntimeError(f"train CLI checkpoints: latest {latest}, swa {swa_ok}, "
                           f"gmms {[len(g) for g in gmms.values()]}")
    n = run["launches"]
    need = ("ffn_ln", "ffn_ln_train", "ffn_ln_train_bwd", "flash_attention",
            "flash_attention_bwd")
    if not all(n[k] > 0 for k in need):
        raise RuntimeError(f"train CLI launches {n}")
    # host ms a step: the logged interval rates, eval and checkpoint steps
    # among them; the loop's share spent waiting for the loader
    step_ms = [1e3 / l["train/steps_per_s"] for l in train_lines]
    waits = {"loop_s": res.loop_s, "loader_wait_s": res.loader_wait_s,
             "first_batch_s": res.first_batch_s,
             "wait_share": res.loader_wait_s / res.loop_s,
             "wait_share_after_first": ((res.loader_wait_s - res.first_batch_s)
                                        / (res.loop_s - res.first_batch_s))}
    # one more step of the trained model on the run's first batch, profiled
    bucketer = Bucketer(cfg.model.max_phones, cfg.model.max_frames)
    batch = next(batch_iterator(ds, 8, bucketer, seed=cfg.train.seed))
    step = make_train_step(res.state.model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(res.state, batch, gen)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(res.state, batch, gen)
        torch.cuda.synchronize()
    split = _step_split(prof, "train_cli_profile.txt")
    row = {"phase": "train_cli", "corpus": f"make_rich_corpus {TC_SPEAKERS} x {TC_UTTS}, "
                                           f"{TC_WORDS[0]}-{TC_WORDS[1]} words, seed 0",
           "corpus_s": corpus_s, "cli_s": run["s"], "cli_timeline": run["timeline"],
           "steps": TC_STEPS,
           "steps_per_s_loop": TC_STEPS / res.loop_s,
           "host_ms_a_step_median": statistics.median(step_ms), "host_ms_a_step": step_ms,
           **waits, "launches": n, "flash_routes": run["flash_routes"],
           "first_loss": train_lines[0]["train/total_loss"],
           "last_loss": train_lines[-1]["train/total_loss"],
           "eval_mel_loss": [l["eval/mel_loss"] for l in eval_lines],
           "eval_metrics_final": {k: v for k, v in eval_lines[-1].items() if k != "ts"},
           "latest": latest, "swa": swa_ok, "profiled_step": {
               "frame_bucket": int(batch["mel"].shape[1]), **{k: split[k] for k in (
                   "device_ms", "device_launches", "ffn_ln_train_ms", "ffn_ln_train_bwd_ms",
                   "flash_attention_ms", "flash_attention_bwd_ms")}},
           "nvidia_smi": smi}
    emit(row)

    # a warm start from the bf16 run: every tensor restored
    warm = _train_cli(cli, base + ["--checkpoint_dir", str(work / "warm"), "--max_steps", "2",
                                   "--num_workers", "0", "--from_checkpoint", str(ck)], counters)
    n_params = len(tree["params"])
    if f"warm start: {n_params} tensors restored, 0 kept fresh" not in warm["stdout"]:
        raise RuntimeError(f"warm start: {warm['stdout'][-500:]}")
    # the soft-DTW mel loss with the opt-in regulator
    with env_opt_in("LFS2_PALLAS_LR"):
        sdtw = _train_cli(cli, base + ["--checkpoint_dir", str(work / "sdtw"), "--max_steps", "2",
                                       "--num_workers", "0", "--mel_loss", "soft_dtw"], counters)
    ns = sdtw["launches"]
    if not all(ns[k] > 0 for k in ("soft_dtw", "soft_dtw_bwd", "regulate", "regulate_bwd",
                                   "ffn_ln_train", "flash_attention")):
        raise RuntimeError(f"soft-DTW train CLI launches {ns}")
    sdtw_losses = [h["total"] for h in sdtw["result"].history]
    if not all(math.isfinite(v) for v in sdtw_losses):
        raise RuntimeError(f"soft-DTW train CLI losses {sdtw_losses}")

    # f32, every rate 0: the card against the CPU over one feature cache
    f32 = {}
    for dev in ("cuda", "cpu"):
        f32[dev] = _train_cli(cli, [
            "--train_target_path", str(long_corpus), "--checkpoint_dir", str(work / f"f32_{dev}"),
            "--log_dir", str(work / f"f32_logs_{dev}"), "--cache_path", str(work / "long_cache"),
            "--batch_size", "2", "--max_steps", "2", "--log_every", "1", "--num_workers", "0",
            "--precision", "32", "--warmup_steps", "1", "--encoder_dropout", "0",
            "--decoder_dropout", "0", "--variance_dropout", "0", "0", "0",
            "--duration_dropout", "0", "--augment_duration", "0",
            "--variance_transforms", "cwt", "none", "none", "--device", dev], counters)
    ha, hb = f32["cuda"]["result"].history, f32["cpu"]["result"].history
    err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
              for a, b in zip(ha, hb) for k in b if k not in ("steps_per_s", "lr"))
    fr = f32["cuda"]["flash_routes"]
    if not (len(ha) == len(hb) == 2 and err <= TC_LOSS_REL
            and fr["flash_attention"]["flash_attention"] > 0):
        raise RuntimeError(f"f32 train CLI card vs CPU: max rel err {err}, flash {fr}, "
                           f"card {ha}, CPU {hb}")
    # one item's d-vector
    wav, sr = wav_io.read(next(iter(sorted(corpus.rglob("*.wav")))))
    wav = wav[:sr] / max(float(np.abs(wav[:sr]).max()), 1e-9)
    dv = {d: DVectorPipeline(device=d).embed_wav(wav, sr) for d in ("cuda", "cpu")}
    dv_err = float(np.abs(dv["cuda"] - dv["cpu"]).max())
    if dv_err > TC_DVEC_ATOL:
        raise RuntimeError(f"d-vector card vs CPU: {dv_err} > {TC_DVEC_ATOL}")

    # the generate CLI serves the bf16 run's checkpoint with its prior GMMs
    out = work / "gen"
    reset_counts(counters)
    wav_gen = gen_cli.main(["--checkpoint_dir", str(ck), "--sentence", "Hello world.",
                            "--output_path", str(out), "--prior_strategy", "gmm",
                            "--sample_dvector", "--seed", "0"])
    written, gsr = wav_io.read(out / "sentence.wav")
    gen_launches = {c.__name__: c.launches for c in counters if c.launches}
    if not (written.size > 0 and gsr == SAMPLING_RATE and np.isfinite(wav_gen).all()
            and gen_launches.get("ffn_ln", 0) > 0):
        raise RuntimeError(f"generate from the trained checkpoint: {written.size} samples at "
                           f"{gsr} Hz, launches {gen_launches}")
    tail = {"phase": "train_cli_checks", "warm_start_s": warm["s"],
            "warm_start_tensors": n_params, "soft_dtw_s": sdtw["s"],
            "soft_dtw_launches": {k: v for k, v in ns.items() if v},
            "soft_dtw_losses": sdtw_losses,
            "f32_card_vs_cpu": {"max_rel_err": err, "tol": TC_LOSS_REL,
                                "card": [{k: v for k, v in h.items() if k != "steps_per_s"}
                                         for h in ha],
                                "cpu_s": f32["cpu"]["s"], "card_s": f32["cuda"]["s"],
                                "flash_routes": fr},
            "dvector_card_vs_cpu": {"max_abs_err": dv_err, "tol": TC_DVEC_ATOL},
            "generate": {"samples": int(written.size), "launches": gen_launches},
            "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    emit(tail)
    shutil.rmtree(work, ignore_errors=True)
    return {"row": row, "soft_dtw_launches": ns}


# ------------------------------------------------------- canonical joint
CJ_SPEAKERS, CJ_UTTS = 4, 2            # phase 26's long-corpus words: 9-12 s an utterance,
CJ_WORDS = TC_LONG_WORDS               # so every batch of 4 takes a frame bucket >= 1024
CJ_STEPS = 6
SRMR_REL = 1e-4                        # per-window SRMR, card against CPU (relative)
CJ_LOSSES = ("mel", "pitch", "energy", "snr", "srmr", "duration", "fastdiff", "speakers")


def canonical_joint_flags() -> list:
    """The train CLI's flags that build ``core/config.py canonical_joint``'s
    model (the flagship defaults otherwise; checked against the preset)."""
    return ["--variances", "pitch", "energy", "snr", "srmr",
            "--variance_levels", *["frame"] * 4, "--variance_transforms", *["none"] * 4,
            "--variance_losses", *["mse"] * 4, "--variance_nlayers", *["5"] * 4,
            "--variance_kernel_size", *["5"] * 4, "--variance_dropout", *["0.1"] * 4,
            "--variance_loss_weights", *["1.0"] * 4, "--decoder_layers", "6",
            "--decoder_kernel_sizes", *["9"] * 6, "--duration_nlayers", "5",
            "--fastdiff_vocoder", "true", "--fastdiff_variances", "true",
            "--fastdiff_speakers", "true"]


def _serve(gen_cli, ck: Path, out: Path, extra: list, counters) -> dict:
    """The generate CLI on one checkpoint, launches counted."""
    from lightningfastspeech2_tpu_torch.data import wav as wav_io

    reset_counts(counters)
    t = time.perf_counter()
    wav = gen_cli.main(["--checkpoint_dir", str(ck), "--sentence", "Hello world.",
                        "--output_path", str(out), "--seed", "0"] + extra)
    torch.cuda.synchronize()
    written, sr = wav_io.read(out / "sentence.wav")
    row = {"s": time.perf_counter() - t, "samples": int(written.size), "sampling_rate": sr,
           "launches": {c.__name__: c.launches for c in counters if c.launches}}
    if not (written.size > 0 and sr == SAMPLING_RATE and np.isfinite(wav).all()):
        raise RuntimeError(f"generate {extra}: {row}")
    return row


def _replay_second_step(argv: list) -> dict:
    """The second step of the card's f32 CLI run of ``argv``, on the CPU
    from the card's own state after the first (``step_00000001``: the
    weights and the optimizer), with the run's second batch, generator and
    draws. Returns its metrics as floats."""
    from lightningfastspeech2_tpu_torch.cli import train as cli
    from lightningfastspeech2_tpu_torch.core.bucketing import Bucketer
    from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer
    from lightningfastspeech2_tpu_torch.data.dataset import TTSDataset
    from lightningfastspeech2_tpu_torch.data.dvector import DVectorPipeline
    from lightningfastspeech2_tpu_torch.models.joint import flatten_joint, schedule_probability
    from lightningfastspeech2_tpu_torch.train import loop
    from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step

    args = cli.build_parser().parse_args(argv)
    ck = Path(args.checkpoint_dir)
    tree, cfg, side = Checkpointer(ck).restore(ck / "step_00000001")
    ds = TTSDataset(Path(args.train_target_path), cli.data_config(args, cfg),
                    stats=side["stats"], speaker2dvector=side["speaker2dvector"],
                    cache_dir=Path(args.cache_path), device="cpu")
    ds.dvector_suffix = DVectorPipeline(device="cpu").cache_tag + ".npy"
    state = create_train_state(loop.build_model(cfg, ds, device="cpu"), cfg)
    state.model.load_state_dict(flatten_joint(tree["params"]))
    state.optimizer.load_state_dict(tree["opt_state"])
    state.step = 1
    batches = loop.batch_iterator(ds, cfg.train.batch_size,
                                  Bucketer(cfg.model.max_phones, cfg.model.max_frames),
                                  seed=cfg.train.seed)
    next(batches)
    batch = {k: x for k, x in next(batches).items() if isinstance(x, np.ndarray)}
    steps_per_epoch = max(len(ds) // cfg.train.batch_size, 1)
    _, metrics = make_train_step(state.model, cfg)(
        state, batch, loop._step_generator(torch.device("cpu"), cfg.train.seed, 1),
        draws=loop._step_draws(cfg.train.seed, 1),
        schedule_p=schedule_probability(cfg.model, 1 // steps_per_epoch))
    return {k: float(x) for k, x in metrics.items()}


def canonical_joint_phase(counters, smi: str) -> dict:
    """Phase 27: the reference's canonical experiment through the port's
    CLIs on the card. A make_rich_corpus corpus of 4 speakers x 2
    utterances of 9-12 s under ``_chip/``; the train CLI trains
    ``canonical_joint`` (the flags checked against the preset) in bf16 at
    B = 4, frame bucket >= 1024, for ``CJ_STEPS`` steps: every branch's loss
    finite, ``ffn_ln_train`` and flash launched, ``lvc_stack`` not (FastDiff
    trains on its plain route). Then one more step profiled and FastDiff's
    training forward and backward timed alone; an f32 2-step run (rates 0,
    B = 2) on the card against the same run on the CPU through one feature
    cache (the draws are made on the CPU, so both take the same): the first
    step held, and the second replayed on the CPU from the card's own
    state after the first and held; a 2-step bf16 flagship run with ``--duration_stochastic``; the
    generate CLI serving the joint checkpoint through FastDiff
    (``lvc_stack`` counted) and through HiFi-GAN (the resblock kernels),
    and the stochastic one; the corpus's SRMR on the card against the
    CPU."""
    import shutil

    from lightningfastspeech2_tpu_torch.audio.srmr import srmr_per_window
    from lightningfastspeech2_tpu_torch.cli import generate as gen_cli
    from lightningfastspeech2_tpu_torch.cli import train as cli
    from lightningfastspeech2_tpu_torch.core import config as C
    from lightningfastspeech2_tpu_torch.core.bucketing import Bucketer
    from lightningfastspeech2_tpu_torch.data.dataset import DataConfig, TTSDataset
    from lightningfastspeech2_tpu_torch.data.synthetic import make_rich_corpus
    from lightningfastspeech2_tpu_torch.models.draws import ModuleStreams
    from lightningfastspeech2_tpu_torch.train.loop import batch_iterator
    from lightningfastspeech2_tpu_torch.train.step import make_train_step, to_device

    t_phase = time.perf_counter()
    work = ROOT / "_chip" / "canonical_joint"
    shutil.rmtree(work, ignore_errors=True)
    corpus = make_rich_corpus(work / "corpus", n_speakers=CJ_SPEAKERS, n_utts=CJ_UTTS, seed=1,
                              min_words=CJ_WORDS[0], max_words=CJ_WORDS[1])
    flags = canonical_joint_flags()
    parsed = cli.args_to_config(cli.build_parser().parse_args(
        ["--train_target_path", str(corpus)] + flags))
    if C.to_dict(parsed.model) != C.to_dict(C.canonical_joint().model):
        raise RuntimeError("the phase's flags do not build canonical_joint")
    base = ["--train_target_path", str(corpus), "--log_every", "1", "--num_workers", "0",
            "--cache_path", str(work / "cache")]

    # bf16, the CLI's defaults otherwise (rates, warm-up, d-vectors)
    torch.cuda.reset_peak_memory_stats()
    ck = work / "joint"
    run = _train_cli(cli, base + flags + [
        "--checkpoint_dir", str(ck), "--log_dir", str(work / "logs"), "--batch_size", "4",
        "--max_steps", str(CJ_STEPS)], counters)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    res, n = run["result"], run["launches"]
    hist = res.history
    bad = [(i, k) for i, h in enumerate(hist) for k in CJ_LOSSES + ("total", "grad_norm")
           if not math.isfinite(h.get(k, float("nan")))]
    if len(hist) != CJ_STEPS or bad:
        raise RuntimeError(f"canonical joint: {len(hist)} steps, not finite {bad}")
    if not (n["ffn_ln_train"] > 0 and n["ffn_ln_train_bwd"] > 0 and n["flash_attention"] > 0
            and n["flash_attention_bwd"] > 0 and n["lvc_stack"] == 0):
        raise RuntimeError(f"canonical joint training launches {n}")
    step_ms = [1e3 / h["steps_per_s"] for h in hist]

    # one more step profiled, and FastDiff's training route alone at the
    # phase's shape (forward and backward of the ε-MSE)
    model = res.state.model
    ds = TTSDataset(corpus, DataConfig(variances=parsed.model.variance.variances,
                                       variance_levels=parsed.model.variance.levels,
                                       variance_transforms=parsed.model.variance.transforms,
                                       load_wav=True),
                    cache_dir=work / "cache", device="cuda")
    bucketer = Bucketer(parsed.model.max_phones, parsed.model.max_frames)
    batch = next(batch_iterator(ds, 4, bucketer, seed=0))
    step = make_train_step(model, parsed)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(res.state, batch, gen, draws=ModuleStreams(0), schedule_p=0.0)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(res.state, batch, gen, draws=ModuleStreams(1), schedule_p=0.0)
        torch.cuda.synchronize()
    split = _step_split(prof, "canonical_joint_profile.txt")
    tb = to_device({k: v for k, v in batch.items() if isinstance(v, np.ndarray)},
                   torch.device("cuda"))
    T = int(tb["mel"].shape[1]) - 2
    hop = model.fastdiff_cfg.hop_length
    wav = tb["wav"][:, : T * hop].float()
    mel = tb["mel"][:, :T].to(model.dtype)
    ts = torch.full((wav.shape[0],), 500.0, device="cuda")

    def fastdiff_train():
        eps = model.fastdiff(wav, mel, ts, train_route=True)
        eps.float().square().mean().backward()

    fastdiff_ms = cuda_ms(fastdiff_train, min_total_ms=300.0, max_iters=10)
    model.zero_grad(set_to_none=True)
    row = {"phase": "canonical_joint", "corpus": f"make_rich_corpus {CJ_SPEAKERS} x {CJ_UTTS}, "
                                                 f"{CJ_WORDS[0]}-{CJ_WORDS[1]} words, seed 1",
           "config": "canonical_joint (bf16)", "batch": 4, "frame_bucket": int(tb["mel"].shape[1]),
           "steps": CJ_STEPS, "cli_s": run["s"], "cli_timeline": run["timeline"],
           "host_ms_a_step": step_ms, "host_ms_a_step_median": statistics.median(step_ms),
           "loop_s": res.loop_s, "peak_gb": peak_gb,
           "losses_first": {k: hist[0][k] for k in CJ_LOSSES + ("total",)},
           "losses_last": {k: hist[-1][k] for k in CJ_LOSSES + ("total",)},
           "launches": n, "flash_routes": run["flash_routes"],
           "profiled_step": {k: split[k] for k in (
               "device_ms", "device_launches", "ffn_ln_train_ms", "ffn_ln_train_bwd_ms",
               "flash_attention_ms", "flash_attention_bwd_ms")},
           "fastdiff_train_fwd_bwd_ms": fastdiff_ms, "fastdiff_samples": list(wav.shape),
           "nvidia_smi": smi}
    emit(row)

    # f32, every rate 0: the card against the CPU over one feature cache.
    # The first step starts both from the same weights and draws. The
    # second starts from each run's own first update, which a ReLU
    # decision taken differently (a pre-activation within an f32 rounding
    # of 0; the diffusion predictors hold millions) can move apart through
    # Adam's first step (about +-lr on every weight whose gradient is near
    # 0): so the second step is also replayed on the CPU from the card's
    # own state after the first (its checkpoint, optimizer included), and
    # held there.
    f32, f32_argv = {}, {}
    for dev in ("cuda", "cpu"):
        f32_argv[dev] = base + flags + [
            "--checkpoint_dir", str(work / f"f32_{dev}"), "--log_dir", str(work / f"f32_l_{dev}"),
            "--batch_size", "2", "--max_steps", "2", "--precision", "32", "--warmup_steps", "1",
            "--checkpoint_every", "1", "--async_checkpoints", "false",
            "--encoder_dropout", "0", "--decoder_dropout", "0", "--variance_dropout",
            "0", "0", "0", "0", "--duration_dropout", "0", "--augment_duration", "0",
            "--device", dev]
        f32[dev] = _train_cli(cli, f32_argv[dev], counters)
    ha, hb = f32["cuda"]["result"].history, f32["cpu"]["result"].history

    def rel_errs(a, b):
        return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for k in b
                if k not in ("steps_per_s", "lr")}

    err = max(rel_errs(ha[0], hb[0]).values())
    replay = _replay_second_step(f32_argv["cuda"])
    replay_err = max(rel_errs(ha[1], replay).values())
    run_step2_err = rel_errs(ha[1], hb[1])
    if not (len(ha) == len(hb) == 2 and err <= TC_LOSS_REL and replay_err <= TC_LOSS_REL):
        raise RuntimeError(f"canonical joint f32 card vs CPU: step 1 max rel err {err}, "
                           f"step 2 replayed {replay_err}; card {ha}, CPU {hb}, replay {replay}")

    # the flagship with the stochastic duration predictor
    sdp_ck = work / "sdp"
    sdp = _train_cli(cli, base + ["--checkpoint_dir", str(sdp_ck), "--log_dir",
                                  str(work / "sdp_logs"), "--batch_size", "4", "--max_steps", "2",
                                  "--duration_stochastic", "true"], counters)
    sdp_hist = sdp["result"].history
    if not (len(sdp_hist) == 2 and all(math.isfinite(h["duration"]) and math.isfinite(h["total"])
                                       for h in sdp_hist)
            and sdp["launches"]["ffn_ln_train"] > 0):
        raise RuntimeError(f"stochastic duration run: {sdp_hist}, {sdp['launches']}")

    # serving: the joint checkpoint through FastDiff and through HiFi-GAN,
    # the stochastic one through HiFi-GAN
    served = {"joint_fastdiff": _serve(gen_cli, ck, work / "gen_fd", ["--use_fastdiff", "true"],
                                       counters),
              "joint_hifigan": _serve(gen_cli, ck, work / "gen_hg", [], counters),
              "sdp_hifigan": _serve(gen_cli, sdp_ck, work / "gen_sdp", [], counters)}
    if not (served["joint_fastdiff"]["launches"].get("lvc_stack", 0) > 0
            and all(served[k]["launches"].get(r, 0) > 0 for k in ("joint_hifigan", "sdp_hifigan")
                    for r in ("resblock", "resblock_trio", "ffn_ln"))):
        raise RuntimeError(f"canonical joint serving launches {served}")

    # the corpus's SRMR, card against CPU
    srmr_err = 0.0
    for entry in ds.entries:
        w = ds._load_audio(entry)
        a = srmr_per_window(w, SAMPLING_RATE, device="cuda").cpu().numpy()
        b = srmr_per_window(w, SAMPLING_RATE, device="cpu").numpy()
        srmr_err = max(srmr_err, float(np.max(np.abs(a - b) / np.abs(b))))
    if srmr_err > SRMR_REL:
        raise RuntimeError(f"SRMR card vs CPU: max rel err {srmr_err} > {SRMR_REL}")

    launches = {}
    for r in [run, f32["cuda"], sdp] + [{"launches": v["launches"]} for v in served.values()]:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    tail = {"phase": "canonical_joint_checks",
            "f32_card_vs_cpu": {"max_rel_err": err, "tol": TC_LOSS_REL,
                                "step2_replayed_from_card_state_max_rel_err": replay_err,
                                "step2_of_the_two_runs_rel_err": run_step2_err,
                                "card": [{k: v for k, v in h.items() if k != "steps_per_s"}
                                         for h in ha],
                                "card_s": f32["cuda"]["s"], "cpu_s": f32["cpu"]["s"]},
            "stochastic_duration": {"s": sdp["s"], "losses": sdp_hist,
                                    "launches": {k: v for k, v in sdp["launches"].items() if v}},
            "serving": served, "srmr_card_vs_cpu": {"max_rel_err": srmr_err, "tol": SRMR_REL,
                                                     "utterances": len(ds.entries)},
            "launches_phase_27": launches,
            "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    emit(tail)
    print(f"phase 27 (canonical joint): {tail['phase_s']:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return {"row": row, "launches": launches}


# ------------------------------------------------------- HiFi-GAN training
VOC_FILES = (2, 4)                     # make_corpus: 2 x 4 utterances of 12-20 phones, 2-4 s
VOC_STEPS, VOC_CKPT_EVERY, VOC_RESUME = 8, 4, 2
V2_STEPS = 2
VOC_LOSSES = ("d_loss", "g_loss", "adv", "fm", "mel")
# the f32 check: one step of a short segment from seeded weights, card
# subprocess against the CPU's. Its losses are means over many values, so
# TF32 moves them little: 8.3e-6 relative in this process with TF32 on,
# against 3.7e-7 for the f32 subprocess (PERF.md §6, an H100); the gate lies
# between
VOC_C4_FLAGS = ["--batch_size", "2", "--segment_size", "2048", "--max_steps", "1",
                "--log_every", "1", "--seed", "7"]
VOC_F32_REL = 2e-6
V2_FLAGS = ["--upsample_initial_channel", "128"]   # config_v2.json: stages of 64, 32, 16, 8


def _voc_subprocess(argv: list, log_dir: Path) -> dict:
    """``python -m ...cli.train_vocoder argv`` in a process of its own (the
    TF32 flags as a user's process starts with them); its first logged
    metrics and seconds."""
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "lightningfastspeech2_tpu_torch.cli.train_vocoder",
                           *argv], cwd=ROOT, capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"train_vocoder {argv}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return {"s": time.perf_counter() - t, "metrics": _metrics_lines(log_dir)[0]}


def _vocoder_frames(gen_cli, argv: list) -> int:
    """The mel frames the generate CLI's vocoder sees for ``argv``'s
    request (its frame bucket)."""
    args = gen_cli.build_parser().parse_args(argv)
    gen, cfg, _ = gen_cli.load_generator(args)
    synth, frames = gen.synthesiser, []

    def recording(mel):
        frames.append(np.shape(mel)[-2])
        return synth(mel)

    gen.synthesiser = recording
    gen_cli.synthesize_sentence(gen, cfg, args)
    return frames[-1]


def _c3_on_card(dev) -> dict:
    """The resblock kernels raise where a gradient is needed, and HiFi-GAN
    V1's training route gives every parameter a gradient on the card and
    equals the serving route."""
    from lightningfastspeech2_tpu_torch.ops import hifigan_resblock as rb
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import (
        Generator, HifiGanConfig, init_generator_weights)

    gen = Generator(HifiGanConfig())
    init_generator_weights(gen, torch.Generator().manual_seed(0))
    with torch.no_grad():   # every stage carries signal, tanh short of saturation
        for p in gen.parameters():
            p.mul_(4.0)
    gen.to(dev)
    raised = []
    for w, kern in ((gen.stage_weights[0][0], rb.resblock), (gen.stage_weights[1][0], rb.resblock_trio)):
        x = torch.randn(1, 64, w.channels, device=dev, requires_grad=True)
        try:
            kern(x, w)
        except RuntimeError as e:
            raised.append("no backward" in str(e))
    mel = torch.randn(1, 16, 80, generator=torch.Generator().manual_seed(3)).to(dev)
    out = gen(mel, train_route=True)
    out.square().mean().backward()
    no_grad = [n for n, p in gen.named_parameters() if p.grad is None or not p.grad.abs().sum() > 0]
    with torch.no_grad():
        served = gen(mel)
    err = (served - out.detach()).abs().max().item()
    tol = 1e-4 * out.detach().abs().max().item()
    row = {"kernels_raise_under_grad": raised, "parameters": len(list(gen.parameters())),
           "without_gradient": no_grad, "train_vs_serving_max_abs_err": err, "tol": tol}
    if raised != [True, True] or no_grad or not err <= tol:
        raise RuntimeError(f"C3 on the card: {row}")
    return row


def hifigan_training_phase(counters, smi: str) -> dict:
    """Phase 28: HiFi-GAN training through the port's train_vocoder CLI on
    the card. A make_corpus corpus of 8 wavs of 2-4 s under ``_chip/``;
    HiFi-GAN V1 at full width (the CLI's defaults: B = 16, segments of
    8192, f32) trains ``VOC_STEPS`` steps with a checkpoint every
    ``VOC_CKPT_EVERY``, then resumes for ``VOC_RESUME`` more: every loss
    finite, no resblock kernel launched (the training route), the host ms
    of each step, one more step profiled (device ms, its largest kernels)
    and peak memory. The f32 check: one step of the CLI in a subprocess on
    the card against the same step with ``--device cpu``. The generate CLI
    serves the V1 checkpoint with phase 17's acoustic checkpoint in f32 and
    bf16 (the resblock kernels at C = 256 .. 32). HiFi-GAN V2 trains
    ``V2_STEPS`` steps and serves in bf16 and f32 (``resblock_trio`` at C
    = 64, 32, 16, 8); the new widths (C = 16, 8) are held against their
    plain versions at the request's lengths, beside the single resblock at
    them. Then C3: the kernels raise under grad, the training route
    reaches every parameter."""
    import shutil

    from lightningfastspeech2_tpu_torch.audio.mel import mel_spectrogram
    from lightningfastspeech2_tpu_torch.cli import generate as gen_cli
    from lightningfastspeech2_tpu_torch.cli import train_vocoder as cli
    from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer
    from lightningfastspeech2_tpu_torch.core.config import AudioConfig
    from lightningfastspeech2_tpu_torch.data import wav as wav_io
    from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus
    from lightningfastspeech2_tpu_torch.ops.hifigan_resblock import resblock, resblock_trio
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import HifiGanConfig
    from lightningfastspeech2_tpu_torch.vocoder.hifigan_train import (
        HifiGanTrainConfig, HifiGanTrainer)
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    work = ROOT / "_chip" / "hifigan_training"
    shutil.rmtree(work, ignore_errors=True)
    corpus = make_corpus(work / "corpus", n_speakers=VOC_FILES[0], n_utts=VOC_FILES[1], seed=2,
                         min_phones=12, max_phones=20)
    lengths = [wav_io.read(p)[0].size / SAMPLING_RATE for p in sorted(corpus.rglob("*.wav"))]

    # V1 at the CLI's defaults: train, checkpoint, resume
    ck, logs = work / "v1", work / "v1_logs"
    base = ["--train_target_path", str(corpus), "--checkpoint_dir", str(ck), "--log_dir", str(logs),
            "--log_every", "1"]
    torch.cuda.reset_peak_memory_stats()
    run = _train_cli(cli, base + ["--max_steps", str(VOC_STEPS),
                                  "--checkpoint_every", str(VOC_CKPT_EVERY)], counters)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    resumed = _train_cli(cli, base + ["--from_checkpoint", str(ck), "--max_steps",
                                      str(VOC_STEPS + VOC_RESUME), "--checkpoint_every", "1000"],
                         counters)
    lines = _metrics_lines(logs)
    losses = [{k: l[f"train/{k}"] for k in VOC_LOSSES} for l in lines]
    bad = [(l["step"], k) for l in lines for k in VOC_LOSSES if not math.isfinite(l[f"train/{k}"])]
    tree, _, sidecar = Checkpointer(ck).restore()
    launched = {k: v for r in (run, resumed) for k, v in r["launches"].items() if v}
    if ([l["step"] for l in lines] != list(range(VOC_STEPS + VOC_RESUME)) or bad
            or tree["step"] != VOC_STEPS + VOC_RESUME or launched.get("resblock")
            or launched.get("resblock_trio")):
        raise RuntimeError(f"V1 training: steps {[l['step'] for l in lines]}, not finite {bad}, "
                           f"saved step {tree['step']}, launches {launched}")
    step_ms = [1e3 / l["train/steps_per_s"] for l in lines if l["train/steps_per_s"] > 0]

    # one more step of the trained V1, profiled, at the CLI's batch
    trainer = HifiGanTrainer(HifiGanConfig(), HifiGanTrainConfig(), AudioConfig(), device=dev)
    trainer.load(tree["params"], tree["opt_state"])
    wav = torch.from_numpy(cli.SegmentSampler(corpus, SAMPLING_RATE, 8192, seed=0).batch(16)).to(dev)
    mel = mel_spectrogram(wav, AudioConfig())[:, :32]
    trainer.train_step(mel, wav)
    torch.cuda.synchronize()
    # the device's wall time of one step (CUDA events on the step's stream)
    # beside the profiler's sum of kernel times
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    trainer.train_step(mel, wav)
    b.record()
    torch.cuda.synchronize()
    event_ms = a.elapsed_time(b)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.train_step(mel, wav)
        torch.cuda.synchronize()
        profiled_host_ms = (time.perf_counter() - t) * 1e3
    step_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    split = _step_split(prof, "hifigan_training_profile.txt", fam={}, top=10)
    del trainer
    row = {"phase": "hifigan_training", "corpus": f"make_corpus {VOC_FILES[0]} x {VOC_FILES[1]}, "
                                                  "12-20 phones, seed 2",
           "wav_seconds": lengths, "config": "HiFi-GAN V1 (config.json), f32, TF32 off",
           "batch": 16, "segment": 8192, "steps": VOC_STEPS, "resumed_steps": VOC_RESUME,
           "cli_s": run["s"], "resume_s": resumed["s"], "losses": losses,
           "host_ms_a_step": step_ms, "host_ms_a_step_median": statistics.median(step_ms),
           "peak_gb_cli_run": peak_gb, "peak_gb_profiled_step": step_peak_gb,
           "event_ms_a_step": event_ms,
           "profiled_step": {"host_ms": profiled_host_ms, "device_ms": split["device_ms"],
                             "device_launches": split["device_launches"],
                             "largest_kernels": split["top_kernels"]},
           "checkpoints": sorted(p.name for p in ck.glob("step_*")),
           "launches_in_training": launched, "nvidia_smi": smi}
    emit(row)

    # f32 means f32: the CLI in a process of its own on the card, and with
    # --device cpu, one step from the same seeded weights and segments
    c4 = {}
    for device in ("cuda", "cpu"):
        d = work / f"c4_{device}"
        c4[device] = _voc_subprocess(
            ["--train_target_path", str(corpus), "--checkpoint_dir", str(d / "ck"),
             "--log_dir", str(d / "logs"), "--device", device, *VOC_C4_FLAGS], d / "logs")
    rel = {k: abs(c4["cuda"]["metrics"][f"train/{k}"] - c4["cpu"]["metrics"][f"train/{k}"])
           / abs(c4["cpu"]["metrics"][f"train/{k}"]) for k in VOC_LOSSES}
    # the same step in this process with TF32 on, beside it: what the check
    # would see if the CLI left TF32 on
    trainer = HifiGanTrainer(HifiGanConfig(), HifiGanTrainConfig(), AudioConfig(),
                             device=dev, seed=7)
    wav = torch.from_numpy(cli.SegmentSampler(corpus, SAMPLING_RATE, 2048, seed=7).batch(2)).to(dev)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = {k: float(v) for k, v in trainer.train_step(
            mel_spectrogram(wav, AudioConfig())[:, :8], wav).items()}
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    del trainer
    rel_tf32 = {k: abs(tf32[k] - c4["cpu"]["metrics"][f"train/{k}"])
                / abs(c4["cpu"]["metrics"][f"train/{k}"]) for k in VOC_LOSSES}
    c4_row = {"phase": "hifigan_f32_cli_vs_cpu", "flags": VOC_C4_FLAGS,
              "losses": {d: {k: c4[d]["metrics"][f"train/{k}"] for k in VOC_LOSSES} for d in c4},
              "max_rel_err": max(rel.values()), "rel_err": rel, "tol": VOC_F32_REL,
              "in_process_tf32_on_max_rel_err": max(rel_tf32.values()),
              "tol_sees_tf32": max(rel_tf32.values()) > VOC_F32_REL,
              "s": {d: c4[d]["s"] for d in c4}, "nvidia_smi": smi}
    emit(c4_row)
    if not max(rel.values()) <= VOC_F32_REL:
        raise RuntimeError(f"train_vocoder f32 on the card against the CPU: {rel} > {VOC_F32_REL}")
    if not max(rel_tf32.values()) > VOC_F32_REL:
        # the control: a gate that TF32 passes cannot tell f32 from TF32
        raise RuntimeError(f"the same step with TF32 on is within the f32 gate: {rel_tf32} "
                           f"<= {VOC_F32_REL}")

    # serving: V1 through the generate CLI with phase 17's acoustic checkpoint
    acoustic = Path(write_cli_checkpoints(work / "acoustic")["acoustic"])
    served, by_width = {}, {}
    expect = {"v1": ({256: 3}, {128: 1, 64: 1, 32: 1}), "v2": ({}, {64: 1, 32: 1, 16: 1, 8: 1})}
    v2 = work / "v2"
    for name, voc in (("v1", ck), ("v2", v2)):
        if name == "v2":
            v2_run = _train_cli(cli, ["--train_target_path", str(corpus), "--checkpoint_dir",
                                      str(v2), "--log_dir", str(work / "v2_logs"), "--log_every",
                                      "1", "--max_steps", str(V2_STEPS), *V2_FLAGS], counters)
            v2_lines = _metrics_lines(work / "v2_logs")
            if (len(v2_lines) != V2_STEPS or v2_run["launches"]["resblock_trio"]
                    or not all(math.isfinite(l[f"train/{k}"]) for l in v2_lines for k in VOC_LOSSES)):
                raise RuntimeError(f"V2 training: {v2_lines}, launches {v2_run['launches']}")
        for prec in ("32", "16"):
            key = f"{name}_{'f32' if prec == '32' else 'bf16'}"
            served[key] = _serve(gen_cli, acoustic, work / f"out_{key}",
                                 ["--hifigan_checkpoint", str(voc), "--vocoder_precision", prec],
                                 counters)
            by_width[key] = {"resblock": dict(resblock.by_width),
                             "resblock_trio": dict(resblock_trio.by_width)}
            if (by_width[key]["resblock"], by_width[key]["resblock_trio"]) != expect[name]:
                raise RuntimeError(f"{key} serving launched {by_width[key]}, want {expect[name]}")
    frames = _vocoder_frames(gen_cli, ["--checkpoint_dir", str(acoustic), "--sentence",
                                       "Hello world.", "--output_path", str(work / "frames"),
                                       "--seed", "0", "--hifigan_checkpoint", str(v2)])
    # the new widths at the V2 request's lengths, against their plain
    # versions: the trio (served) and each resblock alone (not served: V2
    # runs every stage through the trio)
    g = torch.Generator().manual_seed(28)
    v2_cfg = HifiGanConfig(upsample_initial_channel=128)
    narrow = {}
    for dtype, key in ((torch.bfloat16, "v2_bf16"), (torch.float32, "v2_f32")):
        rows = _resblock_cases(dev, frames, g, dtype, cfg=v2_cfg, stages=(2, 3), singles=True)
        for r in rows:
            r["launches_v2_request"] = by_width[key][r["name"]].get(r["channels"], 0)
        narrow[str(dtype)[6:]] = rows
    c3 = _c3_on_card(dev)
    launches = {n: sum(r["launches"].get(n, 0) for r in served.values())
                for n in ("resblock", "resblock_trio")}
    tail = {"phase": "hifigan_training_serving", "served": served, "by_width": by_width,
            "v2_training": {"s": v2_run["s"], "losses": [{k: l[f"train/{k}"] for k in VOC_LOSSES}
                                                         for l in v2_lines]},
            "v2_request_frames": frames, "c3": c3,
            "new_widths": {d: [{k: r[k] for k in ("name", "at", "ms", "plain_ms", "bound_ms",
                                                  "bound_by", "max_abs_err", "tol", "tile",
                                                  "blocks_per_launch", "launches_v2_request")}
                               for r in rows] for d, rows in narrow.items()},
            "launches_phase_28": launches, "phase_s": time.perf_counter() - t_phase,
            "nvidia_smi": smi}
    emit(tail)
    print(f"phase 28 (HiFi-GAN training): {tail['phase_s']:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return {"row": row, "c4": c4_row, "narrow": narrow, "launches": launches}


# ------------------------------------------------------- on-device features
ODF_STEPS = 10
ODF_BATCH = 8
ODF_RUNS = 5                           # timed extractions of one batch: their median
ODF_HOST_MEDIAN = 0.05                 # tests/test_on_device_features.py: host pipeline
ODF_HOST_MEL_ATOL = 1e-3               # against the device's, median error and mel atol
ODF_CWT_ATOL = 1e-5                    # the CWT spectrogram, card (TF32 on) against CPU
G2P_STEPS, G2P_BATCH = 300, 256
DN_STEPS = 50


def _odf_batch(ds, bucketer, seed: int) -> tuple:
    """The first batch the train loop draws from ``ds``: its indices, the
    items collated without duration jitter (so the host pipeline's items
    for the same indices share their durations) as the dataset ships them
    (int16 wavs), and the same with float32 wavs (the samples the host
    pipeline reads)."""
    from lightningfastspeech2_tpu_torch.data.dataset import collate
    from lightningfastspeech2_tpu_torch.data.loader import batch_index_stream

    idx = next(batch_index_stream(len(ds), ODF_BATCH, True, seed, None, None))
    items = [ds.__getitem__(int(i), augment=False) for i in idx]
    arrays = lambda b: {k: v for k, v in b.items() if isinstance(v, np.ndarray)}
    f32 = collate(items, dataclasses.replace(ds.cfg, wav_dtype="float32"), bucketer)
    return [int(i) for i in idx], arrays(ds.collate(items, bucketer)), arrays(f32)


def _yin_flips(wav: torch.Tensor, n_frames, sr: int, card: str = "cuda") -> list:
    """Per item, whether the YIN track on the card and on the CPU differ at
    any of its frames (a decision taken the other way: ``near_decision``),
    and how many frames lie within ``YIN_MARGIN`` of a decision."""
    from lightningfastspeech2_tpu_torch.audio import pitch as pitch_mod

    a = pitch_mod.track(wav.to(card), sr).cpu().numpy()
    b = pitch_mod.track(wav.cpu(), sr).numpy()
    near = pitch_mod.near_decision(pitch_mod.frame_windows(wav.cpu(), sr), sr, YIN_MARGIN).numpy()
    out = []
    for i, n in enumerate(n_frames):
        diff = ((a[i, :n] > 0) != (b[i, :n] > 0)) | (np.abs(a[i, :n] - b[i, :n])
                                                     > 1e-5 * np.maximum(b[i, :n], 1.0))
        off = diff & ~near[i, :n]
        out.append({"flipped": bool(diff.any()), "near": int(near[i, :n].sum()),
                    "off_near": int(off.sum())})
    return out


def _hold_odf(card, cpu, wav, n_frames, stats, flips) -> dict:
    """The on-device features of one batch on the card against the same on
    the CPU, per item at the CPU tests' tolerances: the mel (linear within
    2e-6 of the item's peak, log10 within 1e-4 within 30 dB of it), energy
    and SNR de-normalized within their prefix sums' rounding bounds; the
    pitch (CWT) signal rtol 1e-5, spectrogram atol ``ODF_CWT_ATOL``, mean and
    std rtol 1e-5 in items whose YIN decisions all came out alike (a
    decision taken the other way moves the item's whole CWT)."""
    from lightningfastspeech2_tpu_torch.audio.features import energy_rounding_bound
    from lightningfastspeech2_tpu_torch.audio.snr import snr_rounding_bound

    c = {k: v.float().cpu().numpy() for k, v in card.items() if torch.is_tensor(v)}
    h = {k: v.float().numpy() for k, v in cpu.items() if torch.is_tensor(v)}
    worst: dict = {}
    bad = []

    def note(key, err, tol):
        worst[key] = max(worst.get(key, 0.0), float(err))
        if not err <= tol:
            bad.append((key, float(err), float(tol)))

    for i, n in enumerate(n_frames):
        w = wav[i]
        lin_a, lin_b = 10.0 ** c["mel"][i].astype(np.float64), 10.0 ** h["mel"][i].astype(np.float64)
        peak = lin_b.max()
        loud = lin_b >= 1e-3 * peak
        note("mel_lin_rel", np.abs(lin_a - lin_b).max() / peak, 2e-6)
        note("mel_log", np.abs(c["mel"][i] - h["mel"][i])[loud].max(), 1e-4)
        st = stats["energy"]
        ea, eb = (x["variances_energy"][i].astype(np.float64) * st.std + st.mean for x in (c, h))
        note("energy_sq_over_bound", np.abs(ea ** 2 - eb ** 2).max()
             / energy_rounding_bound(w), 1.0)
        st = stats["snr"]
        sa, sb = (x["variances_snr"][i].astype(np.float64) * st.std + st.mean for x in (c, h))
        note("snr_over_bound", np.abs(sa - sb).max() / max(snr_rounding_bound(w, sb[:n]), 1e-12),
             1.0)
        if flips[i]["flipped"]:
            continue
        ps_a, ps_b = c["variances_pitch_signal"][i], h["variances_pitch_signal"][i]
        note("pitch_signal_rel", (np.abs(ps_a - ps_b) / np.maximum(np.abs(ps_b), 1e-6)).max(), 1e-5)
        note("pitch_spectrogram", np.abs(c["variances_pitch_spectrogram"][i]
                                         - h["variances_pitch_spectrogram"][i]).max(), ODF_CWT_ATOL)
        for k in ("variances_pitch_mean", "variances_pitch_std"):
            note(k[10:] + "_rel", abs(c[k][i] - h[k][i]) / max(abs(h[k][i]), 1e-6), 1e-5)
    if bad:
        raise RuntimeError(f"on-device features card vs CPU: {bad}")
    return worst


def _hold_host(card, items, n_frames) -> dict:
    """The on-device features on the card of a float32-wav batch against the
    CPU host pipeline's items for the same utterances (and durations; the
    int16 transfer's rounding moves the mel's near-silent bins far past
    these tolerances, so the two are compared on the same samples), at the
    JAX package's tolerances for the two paths
    (tests/test_on_device_features.py): the mel log10 within
    ``ODF_HOST_MEL_ATOL`` over each item's frames within 30 dB of its peak,
    and linear within 2e-6 of the peak everywhere (the JAX test holds the
    log10 everywhere, but its two paths share one FFT; the card's and the
    CPU's part in near-silent bins: 2.8e-3 in log10 in a chip run), energy,
    SNR, the pitch signal and spectrogram a median error under
    ``ODF_HOST_MEDIAN``, the pitch mean within 0.2. The two differ by
    design where an item's SNR windows reach its end (the host truncates
    them, the batch's run into padding)."""
    c = {k: v.float().cpu().numpy() for k, v in card.items() if torch.is_tensor(v)}
    out = {"mel_max_abs": 0.0, "mel_lin_rel": 0.0}
    med = {k: [] for k in ("energy", "snr", "pitch_signal", "pitch_spectrogram", "pitch_mean")}
    for i, (item, n) in enumerate(zip(items, n_frames)):
        m = min(n, len(item["mel"]))
        la, lb = (10.0 ** x.astype(np.float64) for x in (c["mel"][i, :m], item["mel"][:m]))
        loud = lb >= 1e-3 * lb.max()
        out["mel_lin_rel"] = max(out["mel_lin_rel"], float(np.abs(la - lb).max() / lb.max()))
        out["mel_max_abs"] = max(out["mel_max_abs"], float(np.abs(
            c["mel"][i, :m] - item["mel"][:m])[loud].max()))
        for var in ("energy", "snr"):
            med[var].append(float(np.median(np.abs(c[f"variances_{var}"][i, :m]
                                                   - item[f"variances_{var}"][:m]))))
        for k in ("signal", "spectrogram"):
            med[f"pitch_{k}"].append(float(np.median(np.abs(
                c[f"variances_pitch_{k}"][i, :m] - item[f"variances_pitch_{k}"][:m]))))
        med["pitch_mean"].append(abs(float(c["variances_pitch_mean"][i])
                                     - float(item["variances_pitch_mean"])))
    out.update({f"{k}_median_err_max": max(v) for k, v in med.items() if k != "pitch_mean"})
    out["pitch_mean_err_max"] = max(med["pitch_mean"])
    if not (out["mel_max_abs"] <= ODF_HOST_MEL_ATOL and out["mel_lin_rel"] <= 2e-6
            and out["pitch_mean_err_max"] <= 0.2
            and all(out[f"{k}_median_err_max"] < ODF_HOST_MEDIAN
                    for k in ("energy", "snr", "pitch_signal", "pitch_spectrogram"))):
        raise RuntimeError(f"on-device features against the host pipeline: {out}")
    return out


def _extraction_times(fn) -> dict:
    """Host ms (the call to its return, and to the card's end) and event ms
    of ``ODF_RUNS`` calls after a warm-up, their medians; one more call
    under torch.profiler: its kernels' device ms and count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    ret, wall, ev = [], [], []
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(ODF_RUNS):
        t = time.perf_counter()
        a.record()
        fn()
        b.record()
        ret.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
        ev.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = _step_split(prof, "on_device_features_profile.txt", fam={}, top=8)
    return {"host_ms_to_return": statistics.median(ret), "host_ms": statistics.median(wall),
            "event_ms": statistics.median(ev), "device_ms": split["device_ms"],
            "device_kernels": split["device_launches"], "top_kernels": split["top_kernels"]}


def _f32_raw_mode_check(cli, counters, work: Path, long_corpus: Path, bucketer,
                        card: str = "cuda") -> dict:
    """Phase 29's f32 raw-mode runs of the train CLI, on ``card`` and on the
    CPU, and their checks (below); ``card="cpu"`` rehearses them."""
    from lightningfastspeech2_tpu_torch.data import dataset as dsm
    from lightningfastspeech2_tpu_torch.data.wav import dequantize
    from lightningfastspeech2_tpu_torch.train.loop import (_step_draws, _step_generator,
                                                           batch_iterator, build_model,
                                                           stats_tree)
    from lightningfastspeech2_tpu_torch.train.on_device_features import (
        augment_batch_with_features)
    from lightningfastspeech2_tpu_torch.train.step import (create_train_state, make_train_step,
                                                           to_device)

    # f32 raw mode, every rate 0: the card against the CPU over one stats
    # cache. Each run computes its targets on its own device, where the
    # mel's near-silent bins (the two FFTs) and the SNR's prefix sums round
    # apart within their bounds (above); the teacher-forced SNR enters the
    # decoder through a 256-bin embedding, so a target at a bin's edge moves
    # the predicted mel, and the mel, SNR and total losses and the gradient
    # norm of the two runs part by more than the step's own rounding. So the
    # CLI's first step is held on the losses ahead of the decoder (energy,
    # duration, and pitch where YIN decided alike) within TC_LOSS_REL, the
    # rest reported with the two targets' largest differences; and the step
    # itself is held whole: one f32 step on the card and one on the CPU from
    # the same weights on the card's features of the same batch, every loss
    # and the gradient norm within TC_LOSS_REL.
    f32_argv = ["--train_target_path", str(long_corpus), "--cache_path", str(work / "long_cache"),
                "--batch_size", "2", "--max_steps", "2", "--log_every", "1", "--num_workers", "0",
                "--precision", "32", "--warmup_steps", "1", "--encoder_dropout", "0",
                "--decoder_dropout", "0", "--variance_dropout", "0", "0", "0",
                "--duration_dropout", "0", "--augment_duration", "0",
                "--variance_transforms", "cwt", "none", "none", "--on_device_features", "True"]
    f32 = {}
    for dev in (card, "cpu"):
        f32[dev] = _train_cli(cli, f32_argv + [
            "--checkpoint_dir", str(work / f"f32_{dev}"), "--log_dir", str(work / f"f32_logs_{dev}"),
            "--device", dev], counters)
    ha, hb = f32[card]["result"].history, f32["cpu"]["result"].history
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-6)
    first = {k: rel(ha[0][k], hb[0][k]) for k in hb[0] if k not in ("steps_per_s", "lr")}
    second = {k: rel(ha[1][k], hb[1][k]) for k in hb[1] if k not in ("steps_per_s", "lr")}
    args32 = cli.build_parser().parse_args(f32_argv + ["--checkpoint_dir", str(work / "f32_x")])
    cfg32 = cli.args_to_config(args32)
    ds32 = dsm.TTSDataset(long_corpus, cli.data_config(args32, cfg32),
                          cache_dir=work / "long_cache", device=card)
    b32 = {k: v for k, v in next(batch_iterator(ds32, 2, bucketer, seed=cfg32.train.seed)).items()
           if isinstance(v, np.ndarray)}
    stats32 = stats_tree(ds32, cfg32.model.variance.variances)
    feats = {dev: augment_batch_with_features(to_device(b32, dev), cfg32, stats32)
             for dev in (card, "cpu")}
    n32 = [int(d.sum()) for d in b32["duration"]]
    delta = {k: max(float((feats[card][k][i, :n].cpu() - feats["cpu"][k][i, :n]).abs().max())
                    for i, n in enumerate(n32)) for k in ("mel", "variances_snr")}
    flips32 = _yin_flips(dequantize(torch.from_numpy(b32["wav"])), n32,
                         cfg32.model.audio.sampling_rate, card)
    gated = [k for k in ("energy", "duration") + (
        () if any(f["flipped"] for f in flips32) else ("pitch_cwt", "pitch_mean", "pitch_std"))]
    replay = {}
    for dev in (card, "cpu"):
        model = build_model(cfg32, ds32, device=dev)
        state = create_train_state(model, cfg32)
        _, m = make_train_step(model, cfg32)(
            state, {k: v.to(dev) for k, v in feats[card].items()},
            _step_generator(model.device, cfg32.train.seed, 0),
            draws=_step_draws(cfg32.train.seed, 0))
        replay[dev] = {k: float(v) for k, v in m.items()}
    replay_err = {k: rel(replay[card][k], v) for k, v in replay["cpu"].items()}
    if not (len(ha) == len(hb) == 2 and all(first[k] <= TC_LOSS_REL for k in gated)
            and max(replay_err.values()) <= TC_LOSS_REL):
        raise RuntimeError(f"f32 raw-mode train CLI card vs CPU: first step {first} (gated "
                           f"{gated}), replay {replay_err}, card {ha}, CPU {hb}")
    return {"first_step_rel_err": first, "second_step_rel_err": second, "gated": gated,
            "tol": TC_LOSS_REL, "target_max_abs_delta": delta,
            "yin": flips32, "replay_rel_err": replay_err,
            "card": [{k: v for k, v in h.items() if k != "steps_per_s"} for h in ha],
            "cpu_s": f32["cpu"]["s"], "card_s": f32[card]["s"],
            "flash_routes": f32[card]["flash_routes"]}


def on_device_features_phase(counters, smi: str) -> dict:
    """Phase 29: on-device features in the train CLI, and the G2P and
    denoiser trainers, on the card. Phase 26's corpora anew under ``_chip/``;
    the CLI trains the flagship in bf16 from raw wavs shipped as int16
    (``--on_device_features True``), ``ODF_STEPS`` steps at batch 8 through a
    2-worker loader with an eval; the run's first batch's features on the
    card (TF32 on, as a bf16 process has it, and both flags on) against the
    same on the CPU and against the CPU host pipeline's items, timed; SRMR
    (``frame_srmr_padded``) on the card against the CPU; one more raw-mode
    step profiled with its peak memory; an f32 raw-mode run of 2 steps on
    the card against the same on the CPU; then the G2P CLI (``G2P_STEPS`` at
    d = 96, batch 256, the shipped lexicon) and the denoiser CLI
    (``DN_STEPS`` on the corpus's wavs), each bundle loaded and served."""
    import shutil

    from lightningfastspeech2_tpu_torch.audio.srmr import frame_srmr_padded
    from lightningfastspeech2_tpu_torch.cli import train as cli
    from lightningfastspeech2_tpu_torch.cli import train_denoiser as dn_cli
    from lightningfastspeech2_tpu_torch.cli import train_g2p as g2p_cli
    from lightningfastspeech2_tpu_torch.core.bucketing import Bucketer
    from lightningfastspeech2_tpu_torch.data import dataset as dsm
    from lightningfastspeech2_tpu_torch.data.synthetic import make_rich_corpus
    from lightningfastspeech2_tpu_torch.data.wav import dequantize
    from lightningfastspeech2_tpu_torch.synthesis import denoiser as dn
    from lightningfastspeech2_tpu_torch.synthesis.g2p import BUILTIN_LEXICON
    from lightningfastspeech2_tpu_torch.synthesis.neural_g2p import NeuralG2P
    from lightningfastspeech2_tpu_torch.train.loop import stats_tree
    from lightningfastspeech2_tpu_torch.train.on_device_features import (
        augment_batch_with_features)
    from lightningfastspeech2_tpu_torch.train.step import make_train_step, to_device

    t_phase = time.perf_counter()
    work = ROOT / "_chip" / "odf"
    shutil.rmtree(work, ignore_errors=True)
    corpus = make_rich_corpus(work / "corpus", n_speakers=TC_SPEAKERS, n_utts=TC_UTTS, seed=0,
                              min_words=TC_WORDS[0], max_words=TC_WORDS[1])
    long_corpus = make_rich_corpus(work / "long", n_speakers=2, n_utts=2, seed=1,
                                   min_words=TC_LONG_WORDS[0], max_words=TC_LONG_WORDS[1])
    valid = make_rich_corpus(work / "valid", n_speakers=TC_SPEAKERS, n_utts=2, seed=2,
                             min_words=TC_VALID_WORDS[0], max_words=TC_VALID_WORDS[1])
    ck, logs, cache = work / "ckpt", work / "logs", work / "cache"
    argv = ["--train_target_path", str(corpus), "--valid_target_path", str(valid),
            "--checkpoint_dir", str(ck), "--log_dir", str(logs), "--cache_path", str(cache),
            "--batch_size", str(ODF_BATCH), "--log_every", "1", "--max_steps", str(ODF_STEPS),
            "--eval_every", str(ODF_STEPS), "--checkpoint_every", str(ODF_STEPS),
            "--num_workers", "2", "--variance_transforms", "cwt", "none", "none",
            "--on_device_features", "True", "--wav_transfer_dtype", "int16"]
    run = _train_cli(cli, argv, counters)
    res = run["result"]
    lines = _metrics_lines(logs)
    train_lines = [l for l in lines if "train/total_loss" in l]
    eval_lines = [l for l in lines if "eval/mel_loss" in l]
    bad = [(l["step"], k) for l in lines for k, v in l.items()
           if k.startswith(("train/", "eval/")) and not math.isfinite(v)]
    n = run["launches"]
    need = ("ffn_ln_train", "ffn_ln_train_bwd", "flash_attention", "flash_attention_bwd", "ffn_ln")
    if len(train_lines) != ODF_STEPS or len(eval_lines) != 2 or bad or not all(
            n[k] > 0 for k in need):
        raise RuntimeError(f"on-device features train CLI: {len(train_lines)} step lines, "
                           f"{len(eval_lines)} evals, not finite {bad[:8]}, launches {n}")
    step_ms = [1e3 / l["train/steps_per_s"] for l in train_lines]

    # the run's first batch, from the run's own data config and cached stats
    args = cli.build_parser().parse_args(argv)
    cfg = cli.args_to_config(args)
    ds = dsm.TTSDataset(corpus, cli.data_config(args, cfg), cache_dir=cache, device="cuda")
    bucketer = Bucketer(cfg.model.max_phones, cfg.model.max_frames)
    idx, batch, batch_f32 = _odf_batch(ds, bucketer, cfg.train.seed)
    stats = stats_tree(ds, cfg.model.variance.variances)
    hop = cfg.model.audio.hop_length
    n_frames = [int(d.sum()) for d in batch["duration"]]
    wav = dequantize(torch.from_numpy(batch["wav"]))
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on_card = lambda: augment_batch_with_features(to_device(batch, "cuda"), cfg, stats)
        card = on_card()
        times = _extraction_times(on_card)
        card_f32 = augment_batch_with_features(to_device(batch_f32, "cuda"), cfg, stats)
        tf32 = [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    t = time.perf_counter()
    cpu = augment_batch_with_features(to_device(batch, "cpu"), cfg, stats)
    cpu_ms = (time.perf_counter() - t) * 1e3
    flips = _yin_flips(wav, n_frames, cfg.model.audio.sampling_rate)
    worst = _hold_odf(card, cpu, batch["wav"].astype(np.float32) / 32768.0, n_frames,
                      dict(stats), flips)
    # the CPU host pipeline's items for the same utterances
    host_cfg = dataclasses.replace(cli.data_config(args, cfg), raw_mode=False,
                                   mel_dtype="float32", scan_workers=0)
    host_ds = dsm.TTSDataset(corpus, host_cfg, stats=ds.stats, device="cpu")
    host_ds.entries = ds.entries
    t = time.perf_counter()
    host_items = [host_ds.__getitem__(i, augment=False) for i in idx]
    host_item_ms = (time.perf_counter() - t) * 1e3 / len(idx)
    host = _hold_host(card_f32, host_items, n_frames)

    # SRMR: the whole batch on the card (its peak memory), two items on the CPU
    frames_t = torch.tensor(n_frames)
    max_frames = min(wav.shape[1] // hop, cfg.model.max_frames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    srmr_card = frame_srmr_padded(wav.cuda(), (frames_t * hop).cuda(), frames_t.cuda(),
                                  max_frames).cpu().numpy()
    srmr_ms = (time.perf_counter() - t) * 1e3
    srmr_peak_gb = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    srmr_cpu = frame_srmr_padded(wav[:2], frames_t[:2] * hop, frames_t[:2], max_frames).numpy()
    srmr_err = float((np.abs(srmr_card[:2] - srmr_cpu) / np.maximum(np.abs(srmr_cpu), 1e-6)).max())
    if not (np.isfinite(srmr_card).all() and srmr_err <= SRMR_REL):
        raise RuntimeError(f"frame_srmr_padded card vs CPU: {srmr_err} > {SRMR_REL}")

    # one more raw-mode step of the trained model, profiled, with its peak
    step = make_train_step(res.state.model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(res.state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    step(res.state, batch, gen)
    torch.cuda.synchronize()
    step_host_ms = (time.perf_counter() - t) * 1e3
    step_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(res.state, batch, gen)
        torch.cuda.synchronize()
    split = _step_split(prof, "on_device_features_step_profile.txt")
    row = {"phase": "on_device_features", "cli_s": run["s"], "cli_timeline": run["timeline"],
           "steps": ODF_STEPS, "launches": n, "flash_routes": run["flash_routes"],
           "steps_per_s_loop": ODF_STEPS / res.loop_s,
           "host_ms_a_step_median": statistics.median(step_ms), "host_ms_a_step": step_ms,
           "loader_wait_s": res.loader_wait_s, "first_batch_s": res.first_batch_s,
           "first_loss": train_lines[0]["train/total_loss"],
           "last_loss": train_lines[-1]["train/total_loss"],
           "eval_mel_loss": [l["eval/mel_loss"] for l in eval_lines],
           "batch": {"items": idx, "frame_bucket": int(batch["wav"].shape[1] // hop),
                     "frames": n_frames, "wav_dtype": str(batch["wav"].dtype)},
           "extraction": {**times, "tf32_flags_around_the_call": tf32, "cpu_ms": cpu_ms,
                          "host_pipeline_ms_an_item_cpu": host_item_ms},
           "card_vs_cpu": worst, "yin": flips, "card_vs_host_pipeline": host,
           "int16_vs_float32_mel_max_abs": float((card["mel"] - card_f32["mel"]).abs().max()),
           "srmr": {"max_rel_err": srmr_err, "tol": SRMR_REL, "card_ms": srmr_ms,
                    "peak_gb_above_start": srmr_peak_gb},
           "profiled_step": {"host_ms": step_host_ms, "peak_gb": step_peak_gb,
                             **{k: split[k] for k in (
                                 "device_ms", "device_launches", "ffn_ln_train_ms",
                                 "ffn_ln_train_bwd_ms", "flash_attention_ms",
                                 "flash_attention_bwd_ms")}},
           "nvidia_smi": smi}
    emit(row)

    f32 = _f32_raw_mode_check(cli, counters, work, long_corpus, bucketer)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags

    # the G2P and the denoiser trainers through their CLIs, on the card
    out_g2p = work / "g2p.npz"
    t = time.perf_counter()
    g2p = g2p_cli.main(["--lexicon", BUILTIN_LEXICON, "--out", str(out_g2p),
                        "--steps", str(G2P_STEPS), "--batch_size", str(G2P_BATCH)])
    g2p_s = time.perf_counter() - t
    loaded = NeuralG2P.load(out_g2p)
    oov = loaded(["zyxwort"])[0]
    out_dn = work / "denoiser.npz"
    t = time.perf_counter()
    dres = dn_cli.main(["--corpus", str(corpus), "--steps", str(DN_STEPS), "--out", str(out_dn)])
    dn_s = time.perf_counter() - t
    net = dn.load(out_dn)
    mag = torch.rand(256, 513, generator=torch.Generator().manual_seed(0)).cuda() + 0.01
    masked = dn.apply_mask_net(net, mag)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    if not (np.isfinite(g2p["losses"]).all() and oov and np.isfinite(dres["losses"]).all()
            and bool(torch.isfinite(masked).all()) and loaded.device.type == "cuda"):
        raise RuntimeError(f"G2P / denoiser training: {g2p['losses'][-3:]}, {oov}, "
                           f"{dres['losses'][-3:]}")
    tail = {"phase": "on_device_features_checks",
            "f32_card_vs_cpu": f32,
            "g2p": {"steps": G2P_STEPS, "batch": G2P_BATCH, "s": g2p_s,
                    "first_loss": g2p["losses"][0], "last_loss": g2p["losses"][-1],
                    "held": g2p["held"], "word_accuracy": g2p["word_accuracy"],
                    "per": g2p["per"], "oov_zyxwort": oov},
            "denoiser": {"steps": DN_STEPS, "clips": dres["clips"], "s": dn_s,
                         "first_loss": dres["losses"][0], "last_loss": dres["losses"][-1]},
            "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    emit(tail)
    print(f"phase 29 (on-device features, G2P and denoiser training): {tail['phase_s']:.1f} s",
          flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return {"row": row, "launches": n}


# ------------------------------------------------ data parallel (phase 30)
DP_STEPS = 10
DP_BATCH = 8                           # the global batch: 4 a rank
DP_RANKS = 2                           # sharing the one card over gloo
DP_F32_REL = 1e-5                      # the f32 2-rank step against one process
DP_ZERO1_REL = 0.1                     # ZeRO-1's parameters after 2 steps against AdamW's:
                                       # the difference's norm over the update's (the bf16
                                       # backward's atomics flip the few updates whose
                                       # gradient is noise; the phase reads the AdamW run
                                       # repeated against itself beside it)
DP_ZERO1_TENSOR = 0.05                 # each tensor's update norm within 5 % of AdamW's
DP_ALLREDUCE_RUNS = 5                  # timed gradient all-reduces: their median


def all_counters() -> tuple:
    """Every kernel wrapper's launch counter, in the ``kernels`` line's
    order."""
    from lightningfastspeech2_tpu_torch.ops.attention import flash_attention, flash_attention_bwd
    from lightningfastspeech2_tpu_torch.ops.fastdiff_lvc import lvc_stack
    from lightningfastspeech2_tpu_torch.ops.ffn import ffn_ln, ffn_ln_train, ffn_ln_train_bwd
    from lightningfastspeech2_tpu_torch.ops.hifigan_resblock import resblock, resblock_trio
    from lightningfastspeech2_tpu_torch.ops.length_regulator import regulate, regulate_bwd
    from lightningfastspeech2_tpu_torch.ops.probe import probe
    from lightningfastspeech2_tpu_torch.ops.soft_dtw import soft_dtw, soft_dtw_bwd

    return (probe, ffn_ln, resblock, resblock_trio, ffn_ln_train, ffn_ln_train_bwd,
            flash_attention, flash_attention_bwd, soft_dtw, soft_dtw_bwd, regulate,
            regulate_bwd, lvc_stack)


def _optimizer_bytes(optimizer) -> int:
    """Bytes of the tensors this rank's optimizer holds (its moments and
    step counts): a ZeRO-1 optimizer's own share."""
    local = getattr(optimizer, "optim", optimizer)
    return sum(t.numel() * t.element_size() for st in local.state.values()
               for t in st.values() if torch.is_tensor(t))


def _rank_profile(cli, argv, result, rank: int) -> dict:
    """One more step of ``result``'s state on this rank's share of the run's
    first global batch, profiled (device ms, this rank's kernel table), and
    the gradient all-reduce's host ms (gloo copies through the host: not
    NCCL's time)."""
    from torch.profiler import ProfilerActivity, profile

    from lightningfastspeech2_tpu_torch.core.bucketing import Bucketer
    from lightningfastspeech2_tpu_torch.data.dataset import TTSDataset
    from lightningfastspeech2_tpu_torch.train.loop import batch_iterator, common_bucket
    from lightningfastspeech2_tpu_torch.train.step import make_train_step

    args = cli.build_parser().parse_args(argv)
    cfg = cli.args_to_config(args)
    mesh = cli.make_train_mesh(cfg, args.batch_size)
    ds = TTSDataset(Path(args.train_target_path), cli.data_config(args, cfg),
                    cache_dir=Path(args.cache_path), device="cuda").shard_across_hosts(mesh)
    batch = next(batch_iterator(ds, args.batch_size // mesh.data,
                                Bucketer(cfg.model.max_phones, cfg.model.max_frames),
                                seed=cfg.train.seed))
    arrs = common_bucket({k: v for k, v in batch.items()
                          if isinstance(v, (np.ndarray, torch.Tensor))}, ds.cfg, mesh)
    step = make_train_step(result.state.model, cfg, mesh)
    gen = torch.Generator(device="cuda").manual_seed(rank)
    step(result.state, arrs, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(result.state, arrs, gen)
        torch.cuda.synchronize()
    split = _step_split(prof, f"parallel_profile_rank{rank}.txt")
    n = sum(p.numel() for p in result.state.model.parameters())
    flat = torch.zeros(n, device="cuda")
    times = []
    for _ in range(DP_ALLREDUCE_RUNS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mesh.sum(flat)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return {"frame_bucket": int(arrs["mel"].shape[1]), "local_batch": int(arrs["mel"].shape[0]),
            "device_ms": split["device_ms"], "device_launches": split["device_launches"],
            "gradient_floats": n, "allreduce_host_ms_median": statistics.median(times[1:]),
            "allreduce_host_ms": times[1:]}


def cli_rank_main(runs_file: str) -> int:
    """One rank of phase 30 under ``torch.distributed.run``: joins the world
    (``parallel/mesh.py distributed_init``), then runs each train CLI run of
    ``runs_file`` (a JSON list of ``{"name", "argv", "profile"}``) with the
    launch counts set to 0 just before and read just after, its peak
    memory and optimizer bytes; writes ``chiprun_out/parallel_rank<r>.json``."""
    import torch.distributed as dist

    from lightningfastspeech2_tpu_torch.cli import train as cli
    from lightningfastspeech2_tpu_torch.parallel import mesh as mesh_lib

    backend = mesh_lib.distributed_init("cuda")
    rank = mesh_lib.rank()
    counters = all_counters()
    out = {"rank": rank, "backend": backend, "world": mesh_lib.world_size(),
           "device": torch.cuda.current_device(), "runs": {}}
    try:
        for run in json.loads(Path(runs_file).read_text()):
            reset_counts(counters)
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            result = cli.main(run["argv"])
            torch.cuda.synchronize()
            row = {"s": time.perf_counter() - t,
                   "launches": {c.__name__: c.launches for c in counters},
                   "flash_routes": flash_routes(counters),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "optimizer": type(result.state.optimizer).__name__,
                   "optimizer_bytes": _optimizer_bytes(result.state.optimizer),
                   "steps": result.state.step, "history": result.history,
                   "loop_s": result.loop_s, "loader_wait_s": result.loader_wait_s,
                   "first_batch_s": result.first_batch_s}
            if run.get("profile"):
                row["profiled_step"] = _rank_profile(cli, run["argv"], result, rank)
            out["runs"][run["name"]] = row
            del result
    finally:
        (ROOT / "chiprun_out" / f"parallel_rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()
    return 0


def _torchrun(args: list, log: Path, timeout: int, n_ranks: int) -> float:
    """``python -m torch.distributed.run --standalone --nproc_per_node
    n_ranks args`` in a session of its own (killed whole on a timeout),
    its output in ``log``; raises when any rank failed. Returns seconds."""
    import signal

    t = time.perf_counter()
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc_per_node", str(n_ranks), *args], cwd=ROOT,
                                stdout=fh, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    if rc != 0:
        raise RuntimeError(f"torch.distributed.run {args[:3]}: exit {rc}\n"
                           f"{log.read_text()[-6000:]}")
    return time.perf_counter() - t


def _nccl_world_of_one() -> dict:
    """The mesh helpers in a world of one NCCL rank (the card can hold one
    NCCL rank): the sum, the max and min, the any, the gather and a
    barrier, each checked."""
    import socket

    import torch.distributed as dist

    from lightningfastspeech2_tpu_torch.parallel import mesh as mesh_lib

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = mesh_lib.make_mesh()
        x = torch.arange(8, dtype=torch.float32, device="cuda")
        ok = {"backend": dist.get_backend(mesh.data_group),
              "sum": bool(torch.equal(mesh.sum(x.clone()), x)),
              "max_min": mesh.max([3, 5]) == [3, 5] and mesh.min([3, 5]) == [3, 5],
              "any": bool(torch.equal(mesh.any(x > 3), x > 3)),
              "gather": mesh.gather({"a": 1}) == [{"a": 1}]}
        mesh_lib.barrier("nccl_world_of_one")
    finally:
        dist.destroy_process_group()
    if not (ok["backend"] == "nccl" and all(v for k, v in ok.items() if k != "backend")):
        raise RuntimeError(f"mesh helpers under NCCL: {ok}")
    return ok


def parallel_phase(counters, smi: str, one_rank: dict = None, n_ranks: int = DP_RANKS) -> dict:
    """Phase 30: data-parallel training on the card. ``n_ranks`` ranks
    (``torch.distributed.run``, this script's ``cli_rank_main`` on each;
    two share one card over gloo, ranks with a card each take NCCL) run
    the train CLI on phase 26's corpora
    anew: the flagship in bf16 at the global batch ``DP_BATCH``,
    ``DP_STEPS`` steps through 2 loader workers a rank, once with AdamW
    (with evals) and once with ``--zero1`` (checkpoints every 2 steps, held
    to each other at step 2, beside the AdamW run's first 2 steps repeated),
    then an f32 step at the global batch ``n_ranks`` on a corpus of as
    many utterances, held to the same step in this process. Each rank's
    launches, host ms a step, one profiled step's device ms, the gradient
    all-reduce's host ms, peak memory and optimizer bytes; then the mesh
    helpers in a world of one NCCL rank."""
    import shutil

    from lightningfastspeech2_tpu_torch.cli import train as cli
    from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer
    from lightningfastspeech2_tpu_torch.data.dataset import TTSDataset
    from lightningfastspeech2_tpu_torch.data.synthetic import make_rich_corpus
    from lightningfastspeech2_tpu_torch.train.loop import build_model

    t_phase = time.perf_counter()
    work = ROOT / "_chip" / "parallel"
    shutil.rmtree(work, ignore_errors=True)
    corpus = make_rich_corpus(work / "corpus", n_speakers=TC_SPEAKERS, n_utts=TC_UTTS, seed=0,
                              min_words=TC_WORDS[0], max_words=TC_WORDS[1])
    valid = make_rich_corpus(work / "valid", n_speakers=TC_SPEAKERS, n_utts=2, seed=2,
                             min_words=TC_VALID_WORDS[0], max_words=TC_VALID_WORDS[1])
    pair = make_rich_corpus(work / "pair", n_speakers=1, n_utts=n_ranks, seed=1,
                            min_words=TC_LONG_WORDS[0], max_words=TC_LONG_WORDS[1])
    # phase 26's bf16 run's corpus, batch, CWT pitch and 2 loader workers;
    # warm-up 1 (updates of lr 1e-4, well above an f32 ulp of the weights,
    # so that the ZeRO-1 and AdamW runs compare), no duration augmentation
    # (each loader worker draws its own, so two runs' batches would
    # differ), no priors, GMMs, d-vectors or SWA
    bf16 = ["--train_target_path", str(corpus), "--cache_path", str(work / "cache"),
            "--batch_size", str(DP_BATCH), "--log_every", "1", "--max_steps", str(DP_STEPS),
            "--checkpoint_every", "2", "--num_workers", "2", "--warmup_steps", "1",
            "--augment_duration", "0", "--compute_dvectors", "False",
            "--variance_transforms", "cwt", "none", "none"]
    f32 = ["--train_target_path", str(pair), "--cache_path", str(work / "pair_cache"),
           "--batch_size", str(n_ranks), "--max_steps", "1", "--log_every", "1",
           "--num_workers", "0",
           "--precision", "32", "--warmup_steps", "1", "--encoder_dropout", "0",
           "--decoder_dropout", "0", "--variance_dropout", "0", "0", "0",
           "--duration_dropout", "0", "--augment_duration", "0",
           "--variance_transforms", "cwt", "none", "none"]
    runs = [{"name": "adamw", "profile": True,
             "argv": bf16 + ["--valid_target_path", str(valid), "--eval_every", str(DP_STEPS),
                             "--checkpoint_dir", str(work / "ck_adamw"),
                             "--log_dir", str(work / "logs_adamw")]},
            {"name": "zero1",
             "argv": bf16 + ["--zero1", "True", "--checkpoint_dir", str(work / "ck_zero1"),
                             "--log_dir", str(work / "logs_zero1")]},
            # the AdamW run's first 2 steps again, batches from this process:
            # two runs' difference, the floor the ZeRO-1 run is read against
            {"name": "repeat",
             "argv": bf16 + ["--max_steps", "2", "--num_workers", "0",
                             "--checkpoint_dir", str(work / "ck_repeat")]},
            {"name": "f32", "argv": f32 + ["--checkpoint_dir", str(work / "ck_f32")]}]
    runs_file = work / "runs.json"
    runs_file.write_text(json.dumps(runs))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    torchrun_s = _torchrun([str(ROOT / "chip_smoke.py"), "--cli-rank", str(runs_file)],
                           ROOT / "chiprun_out" / "parallel_torchrun.log", 600, n_ranks)
    ranks = [json.loads((ROOT / "chiprun_out" / f"parallel_rank{r}.json").read_text())
             for r in range(n_ranks)]
    backend = "nccl" if n_ranks <= torch.cuda.device_count() else "gloo"

    # every rank trained, launched the slice's kernels (the AdamW run also
    # the probe, a process probing its card once, and ``ffn_ln`` in its
    # evals), and logged the global batch's losses (rank 0 wrote them)
    need = {"adamw": ("probe", "ffn_ln", "ffn_ln_train", "ffn_ln_train_bwd", "flash_attention",
                      "flash_attention_bwd"),
            "zero1": ("ffn_ln_train", "ffn_ln_train_bwd", "flash_attention",
                      "flash_attention_bwd")}
    for r in ranks:
        for name in ("adamw", "zero1"):
            run = r["runs"][name]
            losses = [h["total"] for h in run["history"]]
            if not (run["steps"] == DP_STEPS and len(losses) == DP_STEPS
                    and all(math.isfinite(v) for v in losses)
                    and all(run["launches"][k] > 0 for k in need[name])):
                raise RuntimeError(f"rank {r['rank']} {name}: {run['steps']} steps, losses "
                                   f"{losses}, launches {run['launches']}")
        if r["backend"] != backend or r["world"] != n_ranks:
            raise RuntimeError(f"rank {r['rank']}: backend {r['backend']}, world {r['world']}")
    for name in ("adamw", "zero1"):
        logged = [[{k: v for k, v in h.items() if k != "steps_per_s"}
                   for h in r["runs"][name]["history"]] for r in ranks]
        if any(other != logged[0] for other in logged[1:]):
            raise RuntimeError(f"{name}: the ranks logged different losses")
    lines = _metrics_lines(work / "logs_adamw")
    if len([l for l in lines if "train/total_loss" in l]) != DP_STEPS or not any(
            "eval/mel_loss" in l for l in lines):
        raise RuntimeError(f"rank 0's metrics.jsonl: {len(lines)} lines")
    # ZeRO-1 against AdamW: the parameters after 2 steps, against the
    # update from the (seeded) initial weights, over all and tensor by
    # tensor (a tensor no rank broadcast would not have moved); the
    # backward's atomics part two runs' gradients by rounding
    p2 = {name: Checkpointer(work / f"ck_{name}").restore(
        work / f"ck_{name}" / "step_00000002")[0] for name in ("adamw", "zero1", "repeat")}
    args = cli.build_parser().parse_args(runs[0]["argv"])
    cfg = cli.args_to_config(args)
    dcfg = dataclasses.replace(cli.data_config(args, cfg), scan_workers=0)
    init = build_model(cfg, TTSDataset(corpus, dcfg, cache_dir=work / "cache", device="cuda"),
                       device="cuda").state_dict()

    def against_adamw(name):
        """The run's step-2 parameters against the AdamW run's: the norm of
        the difference over the update's, the largest element, and each
        tensor's update norm over AdamW's."""
        diff = update = err = 0.0
        moved = []
        for k, a in p2["adamw"]["params"].items():
            a, z, i = a.double(), p2[name]["params"][k].double(), init[k].cpu().double()
            upd = float(((a - i) ** 2).sum())
            diff += float(((z - a) ** 2).sum())
            update += upd
            err = max(err, float((z - a).abs().max()))
            if upd > 0:
                moved.append(math.sqrt(float(((z - i) ** 2).sum()) / upd))
        return {"diff_over_update": math.sqrt(diff / max(update, 1e-300)), "max_abs_err": err,
                "update_norm": math.sqrt(update), "tensor_update_ratio": [min(moved), max(moved)]}

    zero = against_adamw("zero1")
    repeat = against_adamw("repeat")
    full_state = p2["zero1"]["opt_state"]["state"]
    if (zero["diff_over_update"] > DP_ZERO1_REL
            or max(abs(m - 1) for m in zero["tensor_update_ratio"]) > DP_ZERO1_TENSOR
            or len(full_state) != len(p2["adamw"]["opt_state"]["state"])):
        raise RuntimeError(f"ZeRO-1 after 2 steps: {zero} (AdamW run again: {repeat}), "
                           f"{len(full_state)} parameter states")
    opt_bytes = {name: [r["runs"][name]["optimizer_bytes"] for r in ranks]
                 for name in ("adamw", "zero1")}
    if not all(z < a for z, a in zip(opt_bytes["zero1"], opt_bytes["adamw"])):
        raise RuntimeError(f"optimizer bytes a rank: {opt_bytes}")

    # the f32 step of the ranks against one process on the same global batch
    reset_counts(counters)
    one = _train_cli(cli, f32 + ["--checkpoint_dir", str(work / "ck_f32_one")], counters)
    ha = ranks[0]["runs"]["f32"]["history"][0]
    hb = one["result"].history[0]
    f32_err = {k: abs(ha[k] - hb[k]) / max(abs(hb[k]), 1e-6)
               for k in hb if k not in ("steps_per_s", "lr")}
    if max(f32_err.values()) > DP_F32_REL:
        raise RuntimeError(f"f32 {n_ranks}-rank step against one process: {f32_err}")

    nccl = _nccl_world_of_one()

    def step_ms(r, name, checkpointed):
        """Host ms of the logged intervals after the first: those that hold a
        checkpoint (every 2 steps) or those that do not."""
        ms = [1e3 / h["steps_per_s"] for h in r["runs"][name]["history"]]
        return [m for i, m in enumerate(ms) if i and (i % 2 == 0) == checkpointed]

    row = {"phase": "parallel", "ranks": n_ranks, "cards": torch.cuda.device_count(),
           "backend": backend,
           "global_batch": DP_BATCH, "steps": DP_STEPS, "torchrun_s": torchrun_s,
           "host_ms_a_step_median": {
               name: [statistics.median(step_ms(r, name, False)) for r in ranks]
               for name in ("adamw", "zero1")},
           "host_ms_a_checkpoint_step_median": {
               name: [statistics.median(step_ms(r, name, True)) for r in ranks]
               for name in ("adamw", "zero1")},
           "one_rank_host_ms_a_step_median": (one_rank or {}).get("host_ms_a_step_median"),
           "profiled_step": [r["runs"]["adamw"]["profiled_step"] for r in ranks],
           "peak_gb": {name: [r["runs"][name]["peak_gb"] for r in ranks]
                       for name in ("adamw", "zero1", "f32")},
           "optimizer_bytes": opt_bytes,
           "launches": [r["runs"]["adamw"]["launches"] for r in ranks],
           "flash_routes": [r["runs"]["adamw"]["flash_routes"] for r in ranks],
           "run_s": {name: [r["runs"][name]["s"] for r in ranks]
                     for name in ("adamw", "zero1", "f32")},
           "loader_wait_s": [r["runs"]["adamw"]["loader_wait_s"] for r in ranks],
           "first_loss": ranks[0]["runs"]["adamw"]["history"][0]["total"],
           "last_loss": ranks[0]["runs"]["adamw"]["history"][-1]["total"],
           "zero1_vs_adamw_step2": {**zero, "tol": DP_ZERO1_REL, "tensor_tol": DP_ZERO1_TENSOR},
           "adamw_again_vs_adamw_step2": repeat,
           "f32_ranks_vs_one": {"max_rel_err": max(f32_err.values()), "per_loss": f32_err,
                                "tol": DP_F32_REL, "ranks": ha, "one": hb},
           "nccl_world_of_one": nccl,
           "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    emit(row)
    print(f"phase 30 (data parallel): {row['phase_s']:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return {"row": row,
            "launches": {c.__name__: [r["runs"]["adamw"]["launches"][c.__name__] for r in ranks]
                         for c in counters}}


def parallel_main(n_ranks: int) -> int:
    """``python3 chip_smoke.py --parallel N``: phase 30 alone at ``N``
    ranks after the build (with N cards, one rank a card over NCCL), then
    the nvidia-smi lines and the device line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a Hopper card",
              file=sys.stderr)
        return 1
    from lightningfastspeech2_tpu_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    parallel_phase(all_counters(), smi, None, n_ranks)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# ----------------------------------- B16 widths and the tools (phase 31)
B16_CHANNELS = 384                     # upsample_initial_channel: stages 192, 96, 48, 24
# launches a vocoder call makes, by the stage's own width
B16_WIDTHS = {"resblock": {192: 3}, "resblock_trio": {96: 1, 48: 1, 24: 1}}
PLOT_ITEMS = 4


def _trace_names(path: Path) -> tuple:
    """(every event name, the device kernels' names) of a Chrome trace."""
    events = json.loads(path.read_text())["traceEvents"]
    return ({e.get("name") for e in events},
            {e.get("name") for e in events if e.get("cat") == "kernel"})


def b16_tools_phase(counters, served, smi: str) -> dict:
    """Phase 31: HiFi-GAN stages the kernels run zero-padded (ROADMAP B16)
    and the JAX package's last tools. Phase 5's sentences and batch through
    the flagship with a V1-shaped HiFi-GAN at ``upsample_initial_channel``
    384 (stages 192, 96, 48, 24, run at 256, 128, 64, 32) from seeded
    weights, in bf16 and in f32, each run's launches counted by width and
    no signal padded on the way (``pad_copies``); the f32 request against
    the CPU's plain path (phase 6's tolerance); each new width's launch
    against its plain version at the batch's 512-frame bucket, with its
    time, the unpadded work's bound and the copy a direct call would make;
    ``cli.plot`` on phase 26's corpus without matplotlib (its PNGs under
    ``chiprun_out/plots``); ``dio_pitch`` built with g++ on the host; one
    request under ``profile_trace`` (``chiprun_out/b16_trace/trace.json``)
    holding its ``annotate`` span and the resblock kernels; and the
    resblock library's SASS through ``kernel_dump_to``."""
    import shutil

    from lightningfastspeech2_tpu_torch.cli import plot as plot_cli
    from lightningfastspeech2_tpu_torch.data.synthetic import make_rich_corpus
    from lightningfastspeech2_tpu_torch.native import dio_pitch
    from lightningfastspeech2_tpu_torch.ops.hifigan_resblock import resblock, resblock_trio
    from lightningfastspeech2_tpu_torch.utils import debug
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import HifiGanConfig

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    hcfg = HifiGanConfig(upsample_initial_channel=B16_CHANNELS)
    cfg, dvecs = served["cfg"], served["dvecs"]
    runs, gens = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        gen, _ = _make_generator(cfg, dtype, None, dvecs, BATCH_TEXTS, served["bias"],
                                 hifigan_cfg=hcfg)
        reset_counts(counters)
        copies = resblock.pad_copies + resblock_trio.pad_copies
        run = _serve_all(gen, cfg, dvecs, tag=f"b16_{name}_")
        torch.cuda.synchronize()
        n = len(run["vocoder_buckets"])
        got = {"resblock": dict(resblock.by_width), "resblock_trio": dict(resblock_trio.by_width)}
        want = {k: {c: m * n for c, m in v.items()} for k, v in B16_WIDTHS.items()}
        stages = gen.synthesiser.model.stage_weights
        runs[name] = {"by_width": got, "expected": want,
                      "pad_copies": resblock.pad_copies + resblock_trio.pad_copies - copies,
                      "launches": {c.__name__: c.launches for c in counters},
                      "stage_kernel_channels": [w[0].channels for w in stages],
                      "request_ms": [r["ms"] for r in run["requests"]],
                      "batch_ms": run["batch"]["ms"],
                      "batch_audio_s_per_s": run["batch"]["audio_s_per_s"]}
        emit({"phase": f"b16_{name}_launches", **runs[name]})
        if got != want or runs[name]["pad_copies"]:
            raise RuntimeError(f"the {name} 384-channel serving run launched {got} with "
                               f"{runs[name]['pad_copies']} pad copies, want {want} and none")
        gens[name] = gen
    ref = reference_phase(served, tag="b16_", hifigan_cfg=hcfg)

    g = torch.Generator().manual_seed(31)
    widths = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        rows = _resblock_cases(dev, 512, g, dtype, cfg=hcfg)
        for r in rows:
            r["launches_phase_31"] = runs[name]["by_width"][r["name"]].get(r["channels"], 0)
        widths[name] = rows

    # cli.plot on phase 26's corpus, in a process without matplotlib or PIL
    work = ROOT / "_chip" / "b16_tools"
    shutil.rmtree(work, ignore_errors=True)
    t = time.perf_counter()
    corpus = make_rich_corpus(work / "corpus", n_speakers=TC_SPEAKERS, n_utts=TC_UTTS, seed=0,
                              min_words=TC_WORDS[0], max_words=TC_WORDS[1])
    plots = ROOT / "chiprun_out" / "plots"
    shutil.rmtree(plots, ignore_errors=True)
    written = plot_cli.main(["--target_path", str(corpus), "--output_path", str(plots),
                             "--n", str(PLOT_ITEMS), "--stat_entries", "4",
                             "--variances", "pitch", "energy", "--variance_transforms", "cwt",
                             "none"])
    plot_s = time.perf_counter() - t
    loaded = sorted(m for m in ("matplotlib", "PIL") if m in sys.modules)
    if len(written) != PLOT_ITEMS or loaded or not all(p.stat().st_size > 1000 for p in written):
        raise RuntimeError(f"cli.plot wrote {written}; imported {loaded}")

    # the native DIO tracker, built with g++ here
    t = time.perf_counter()
    tt = np.arange(SAMPLING_RATE) / SAMPLING_RATE
    wav = sum(np.sin(2 * np.pi * 220.0 * k * tt) / k for k in range(1, 7))
    track = dio_pitch(wav / np.abs(wav).max(), SAMPLING_RATE)
    dio_s = time.perf_counter() - t
    voiced = track[track > 0]
    dio_err = abs(float(np.median(voiced)) - 220.0) / 220.0
    if not (len(voiced) > 0.7 * len(track) and dio_err < 0.01):
        raise RuntimeError(f"dio_pitch: {len(voiced)} of {len(track)} voiced, error {dio_err}")

    # one bf16 request under the profiler, inside an annotate span
    trace_dir = ROOT / "chiprun_out" / "b16_trace"
    with debug.profile_trace(trace_dir):
        with debug.annotate("lfs2_b16_request"):
            gens["bfloat16"].generate_from_text(SENTENCES[2], speaker="spk0", seed=0)
    names, kernels = _trace_names(trace_dir / debug.TRACE_FILE)
    resblock_kernels = sorted(k for k in kernels if "resblock_kernel" in k)
    if "lfs2_b16_request" not in names or not resblock_kernels:
        raise RuntimeError(f"the trace holds no annotate span or no resblock kernel: "
                           f"{sorted(kernels)[:20]}")
    dumped = debug.kernel_dump_to(work / "dump", names=("resblock",), ptx=False)
    sass = dumped["resblock"]["sass"].read_text()
    if "HGMMA" not in sass or "wg_resblock_kernel" not in sass:
        raise RuntimeError("kernel_dump_to: the resblock SASS lacks its wgmma kernel")
    shutil.rmtree(work, ignore_errors=True)

    keys = ("name", "at", "route", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "tol", "tile", "blocks_per_launch", "pad_copy_ms", "direct_call_ms",
            "launches_phase_31")
    tail = {"phase": "b16_tools", "hifigan": f"V1 at upsample_initial_channel {B16_CHANNELS}",
            "runs": runs, "reference_max_abs_err": ref["max_abs_err"], "reference_tol": ref["tol"],
            "widths": {d: [{k: r.get(k) for k in keys} for r in rows]
                       for d, rows in widths.items()},
            "plot": {"files": [p.name for p in written], "s": plot_s, "imported": loaded},
            "dio_pitch": {"s_with_build": dio_s, "median_rel_err": dio_err},
            "trace": {"resblock_kernels": resblock_kernels, "events": len(names),
                      "file_bytes": (trace_dir / debug.TRACE_FILE).stat().st_size},
            "sass_bytes": len(sass), "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    emit(tail)
    print(f"phase 31 (B16 widths and tools): {tail['phase_s']:.1f} s", flush=True)
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in ("resblock", "resblock_trio")}
    return {"widths": widths, "launches": launches}


# --------------------------- the widths past C = 256 (phase 32: B9t, B16w)
W_FLAGS = ["--encoder_hidden", "512", "--decoder_hidden", "512", "--encoder_head", "4",
           "--decoder_head", "4", "--encoder_conv_filter_size", "1024",
           "--decoder_conv_filter_size", "1024"]
W_STEPS, W_BLOCKS = 3, 8               # bf16 steps; FFT blocks (4 + 4, the flagship's)
# the training widths past 256: what a depthwise block builds (F a multiple
# of C), then what the JAX fit estimate alone also admits
W_TRAIN = [(384, 384), (384, 768), (384, 1152), (512, 512), (512, 1024), (640, 640), (768, 768),
           (384, 1024), (640, 1024), (768, 896)]
# (B, T, k) of the chain's checks: bf16 at the training step's encoder and
# decoder shapes; f32 at phase 9's (the f32 step against the CPU), where
# moving b1 off the ReLU kink clears every column (a comparison of two f32
# sums: at B T = 16384 rows each column holds ReLU inputs within rounding
# of zero)
W_TRAIN_SHAPES = {torch.bfloat16: ((TRAIN_B, TRAIN_P, 5), (TRAIN_B, TRAIN_T, 17)),
                  torch.float32: ((2, 128, 5), (2, 1024, 17))}
W_TIMED_MS = 40.0                      # CUDA-event time each timing fills
W_VOC = 1024                           # upsample_initial_channel: stages 512, 256, 128, 64
W_VOC_FLAGS = ["--upsample_initial_channel", str(W_VOC), "--batch_size", "4", "--max_steps", "3",
               "--log_every", "1", "--checkpoint_every", "1000"]
# a vocoder call's launches by the stage's width
W_VOC_WIDTHS = {"resblock": {512: 3, 256: 3}, "resblock_trio": {128: 1, 64: 1}}
W_DIRECT = (1024, 768, 640)            # upsample_initial_channel: stage 0 at C = 512, 384, 320


def wide_phase(counters, smi: str) -> dict:
    """Phase 32: the widths past C = 256. (a) The train CLI at hidden 512 (4
    heads, filter 1024, 4 + 4 blocks, the flagship otherwise) on phase 26's
    corpus: ``W_STEPS`` bf16 steps, every FFN half through ``ffn_ln_train``
    at C = 512 (``csrc/ffn_wide.cu``), its launches by width equal to the
    steps' blocks; one f32 step on the card against the CPU's (rates 0,
    ``TC_LOSS_REL``). (b) The training chain at every width of ``W_TRAIN``,
    both dtypes at ``W_TRAIN_SHAPES``, rate 0.1, against the plain version
    (phase 7's tolerances, each launch against ``ffn_plan``), timed at the
    decoder shape at the widths a block builds; ``ffn_ln`` served at C = 768
    against its plain version. (c) HiFi-GAN at ``upsample_initial_channel``
    1024 through the train_vocoder CLI (3 f32 steps), then served with (a)'s
    acoustic checkpoint through the generate CLI in f32 and bf16: stage 0's
    ``resblock`` on the wide route at C = 512 (3 a call), the other stages on
    theirs, ``ffn_ln`` at C = 512; the f32 request against the same CLI run
    on the CPU (phase 6's tolerance); the wide route at C = 512, 384 and 320
    (run at 384) against its plain version at a 512-frame mel."""
    import shutil

    from lightningfastspeech2_tpu_torch.cli import generate as gen_cli
    from lightningfastspeech2_tpu_torch.cli import train as cli
    from lightningfastspeech2_tpu_torch.cli import train_vocoder as voc_cli
    from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus, make_rich_corpus
    from lightningfastspeech2_tpu_torch.ops.ffn import ffn_ln, ffn_ln_train, ffn_ln_train_bwd
    from lightningfastspeech2_tpu_torch.ops.hifigan_resblock import resblock, resblock_trio
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import HifiGanConfig

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    work = ROOT / "_chip" / "wide"
    shutil.rmtree(work, ignore_errors=True)
    t = time.perf_counter()
    corpus = make_rich_corpus(work / "corpus", n_speakers=TC_SPEAKERS, n_utts=TC_UTTS, seed=0,
                              min_words=TC_WORDS[0], max_words=TC_WORDS[1])
    long_corpus = make_rich_corpus(work / "long", n_speakers=2, n_utts=2, seed=1,
                                   min_words=TC_LONG_WORDS[0], max_words=TC_LONG_WORDS[1])
    corpus_s = time.perf_counter() - t

    # (a) the train CLI at hidden 512
    ck, logs = work / "ckpt", work / "logs"
    run = _train_cli(cli, ["--train_target_path", str(corpus), "--checkpoint_dir", str(ck),
                           "--log_dir", str(logs), "--cache_path", str(work / "cache"),
                           "--batch_size", "8", "--log_every", "1", "--num_workers", "0",
                           "--max_steps", str(W_STEPS), "--checkpoint_every", str(W_STEPS),
                           *W_FLAGS], counters)
    by_width = {c.__name__: dict(c.by_width) for c in (ffn_ln_train, ffn_ln_train_bwd)}
    lines = [l for l in _metrics_lines(logs) if "train/total_loss" in l]
    bad = [(l["step"], k) for l in lines for k, v in l.items()
           if k.startswith("train/") and not math.isfinite(v)]
    want = {n: {512: W_BLOCKS * len(lines)} for n in by_width}
    if len(lines) != W_STEPS or bad or by_width != want:
        raise RuntimeError(f"hidden-512 train CLI: {len(lines)} steps, not finite {bad}, "
                           f"ffn_ln_train by width {by_width}, want {want}")
    # f32, every rate 0: the first step on the card against the CPU's
    f32 = {}
    for d in ("cuda", "cpu"):
        f32[d] = _train_cli(cli, [
            "--train_target_path", str(long_corpus), "--checkpoint_dir", str(work / f"f32_{d}"),
            "--log_dir", str(work / f"f32_logs_{d}"), "--cache_path", str(work / "long_cache"),
            "--batch_size", "2", "--max_steps", "1", "--log_every", "1", "--num_workers", "0",
            "--precision", "32", "--warmup_steps", "1", "--encoder_dropout", "0",
            "--decoder_dropout", "0", "--variance_dropout", "0", "0", "0",
            "--duration_dropout", "0", "--augment_duration", "0",
            "--variance_transforms", "cwt", "none", "none", *W_FLAGS, "--device", d], counters)
        if d == "cuda":
            f32_widths = dict(ffn_ln_train.by_width)
    ha, hb = f32["cuda"]["result"].history, f32["cpu"]["result"].history
    f32_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                  for a, b in zip(ha, hb) for k in b if k not in ("steps_per_s", "lr"))
    if not (len(ha) == len(hb) == 1 and f32_err <= TC_LOSS_REL
            and f32_widths == {512: W_BLOCKS}):
        raise RuntimeError(f"hidden-512 f32 step card vs CPU: max rel err {f32_err}, "
                           f"ffn_ln_train by width {f32_widths}; card {ha}, CPU {hb}")
    row_a = {"phase": "wide_train_cli", "flags": W_FLAGS, "corpus_s": corpus_s, "cli_s": run["s"],
             "steps": len(lines), "host_ms_a_step": [1e3 / l["train/steps_per_s"] for l in lines],
             "losses": [l["train/total_loss"] for l in lines], "by_width": by_width,
             "launches": run["launches"],
             "f32_card_vs_cpu": {"max_rel_err": f32_err, "tol": TC_LOSS_REL,
                                 "card_s": f32["cuda"]["s"], "cpu_s": f32["cpu"]["s"],
                                 "by_width": f32_widths},
             "nvidia_smi": smi}
    emit(row_a)

    parts_s = {"a": time.perf_counter() - t_phase}
    # (b) the training chain at every width, and serving at C = 768
    g = torch.Generator().manual_seed(32)
    train_rows = {}
    for C, F in W_TRAIN:
        for dtype, shapes in W_TRAIN_SHAPES.items():
            for B, T, k in shapes:
                timed = W_TIMED_MS if T == shapes[-1][1] and F % C == 0 else 0.0
                t = time.perf_counter()
                r = train_rows[(C, F, str(dtype)[6:], T)] = _ffn_train_case(
                    dev, B, T, k, g, dtype, C=C, F=F, timed=timed)
                r["case_s"] = time.perf_counter() - t
    serve_rows = [_ffn_case(dev, B, T, k, dtype, g, C=768, F=F)
                  for F, (B, T, k) in ((768, (8, 512, 17)), (1536, (1, 256, 17)))
                  for dtype in (torch.bfloat16, torch.float32)]

    parts_s["b"] = time.perf_counter() - t_phase - parts_s["a"]
    # (c) HiFi-GAN at 1024 channels: train, serve with (a)'s checkpoint
    voc_corpus = make_corpus(work / "voc_corpus", n_speakers=VOC_FILES[0], n_utts=VOC_FILES[1],
                             seed=2, min_phones=12, max_phones=20)
    voc, voc_logs = work / "voc", work / "voc_logs"
    voc_run = _train_cli(voc_cli, ["--train_target_path", str(voc_corpus), "--checkpoint_dir",
                                   str(voc), "--log_dir", str(voc_logs), *W_VOC_FLAGS], counters)
    voc_lines = _metrics_lines(voc_logs)
    if (len(voc_lines) != 3 or voc_run["launches"]["resblock"]
            or not all(math.isfinite(l[f"train/{n}"]) for l in voc_lines for n in VOC_LOSSES)):
        raise RuntimeError(f"1024-channel HiFi-GAN training: {voc_lines}, "
                           f"launches {voc_run['launches']}")
    served, wavs = {}, {}
    for prec, name in (("32", "f32"), ("16", "bf16")):
        served[name] = _serve(gen_cli, ck, work / f"out_{name}",
                              ["--hifigan_checkpoint", str(voc), "--vocoder_precision", prec],
                              counters)
        got = {"resblock": dict(resblock.by_width), "resblock_trio": dict(resblock_trio.by_width),
               "ffn_ln": dict(ffn_ln.by_width)}
        served[name]["by_width"] = got
        if ({k: got[k] for k in W_VOC_WIDTHS} != W_VOC_WIDTHS or set(got["ffn_ln"]) != {512}):
            raise RuntimeError(f"{name} serving at hidden 512 with the 1024-channel HiFi-GAN "
                               f"launched {got}, want {W_VOC_WIDTHS} and ffn_ln at C = 512")
    # the f32 request's float waveform (the written wav is 16-bit) on the
    # card and on the CPU
    for d in ("cuda", "cpu"):
        t = time.perf_counter()
        wavs[d] = gen_cli.main(["--checkpoint_dir", str(ck), "--sentence", "Hello world.",
                                "--output_path", str(work / f"ref_{d}"), "--seed", "0",
                                "--hifigan_checkpoint", str(voc), "--device", d])
        if d == "cpu":
            cpu_s = time.perf_counter() - t
    a, b = np.asarray(wavs["cuda"]), np.asarray(wavs["cpu"])
    peak = float(np.abs(b).max())
    ref_err = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
    ref_tol = 1e-3 * peak + 1e-7       # phase 6's: summation order through two models
    if not (a.shape == b.shape and ref_err <= ref_tol and peak > 0):
        raise RuntimeError(f"1024-channel f32 request card vs CPU: max |err| {ref_err} > {ref_tol}")
    direct = {}
    for dtype in (torch.bfloat16, torch.float32):
        rows = []
        for uic in W_DIRECT:
            rows += _resblock_cases(dev, 512, g, dtype, cfg=HifiGanConfig(upsample_initial_channel=uic),
                                    stages=(0,))
        for r in rows:
            r["launches_phase_32"] = served["bf16" if dtype == torch.bfloat16 else "f32"][
                "by_width"]["resblock"].get(r["channels"], 0)
        direct[str(dtype)[6:]] = rows
    keys = ("at", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "tol")
    tail = {"phase": "wide", "train_cli": {k: row_a[k] for k in ("cli_s", "steps", "by_width")},
            "train_kernels": {f"{C}x{F} {d} T={T}": {
                "case_s": r["case_s"], **{p: {k: r[p].get(k) for k in keys} for p in ("fwd", "bwd")}}
                for (C, F, d, T), r in train_rows.items()},
            "serve_768": [{k: r[k] for k in keys} for r in serve_rows],
            "vocoder_training": {"s": voc_run["s"],
                                 "losses": [{n: l[f"train/{n}"] for n in VOC_LOSSES}
                                            for l in voc_lines]},
            "served": served, "reference": {"max_abs_err": ref_err, "tol": ref_tol, "peak": peak,
                                            "samples": int(a.size), "cpu_s": cpu_s},
            "resblock_wide": {d: [{k: r.get(k) for k in keys + (
                "channels", "kernel_channels", "route", "tile", "blocks_per_launch",
                "pad_copy_ms", "direct_call_ms", "launches_phase_32")} for r in rows]
                for d, rows in direct.items()},
            "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    tail["parts_s"] = {**parts_s, "c": tail["phase_s"] - parts_s["a"] - parts_s["b"]}
    emit(tail)
    print(f"phase 32 (widths past 256): {tail['phase_s']:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    launches = {"ffn_ln_train": by_width["ffn_ln_train"][512],
                "ffn_ln_train_bwd": by_width["ffn_ln_train_bwd"][512],
                "ffn_ln": sum(r["by_width"]["ffn_ln"].get(768, 0) for r in served.values()),
                "resblock": sum(r["by_width"]["resblock"][512] for r in served.values())}
    return {"train": train_rows, "serve_768": serve_rows, "resblock": direct,
            "launches": launches}


# ------------- the inner widths past 32 and the serving FFN past 768 (phase 33)
# the train CLI's flags of (a): the flagship with FastDiff at 64 inner channels
IW_FLAGS = ["--fastdiff_vocoder", "true", "--fastdiff_inner_channels", "64"]
IW_STEPS = 2
IW_LVC_WIDTHS = (16, 48, 64, 128)      # 48 runs padded to 64
IW_HOPS = (8, 64, 256)                 # FastDiff's stages (stage 1 under LFS2_FUSED_STAGE1)
IW_HIDDEN = 1024                       # (c): 8 heads of 128, filter 1024, 4 + 4 blocks
IW_TEXTS = SENTENCES[:2]               # (c): the batch served through generate_samples
# (d): (C, B, T, F, k); f32 at no more than 2 x 1024 rows, small B T at the widest
IW_FFN = ((896, 2, 512, 896, 17), (1024, 2, 512, 1024, 17), (2048, 1, 512, 2048, 17),
          (4096, 1, 128, 4096, 17))


def inner_widths_phase(counters, served, smi: str) -> dict:
    """Phase 33: the widths the JAX kernels take past the port's earlier
    ones. (a) The train CLI on phase 26's corpus for ``IW_STEPS`` bf16 steps
    of the flagship with FastDiff at 64 inner channels (FastDiff trains on
    its plain route: no ``lvc_stack`` launch), then the generate CLI with
    ``--use_fastdiff true`` on that checkpoint at ``--vocoder_precision`` 16
    and 32: ``lvc_stack.by_width`` must read {64: 8} a request (4 steps x
    stages 2 and 3); the f32 request on the card against the same request
    on the CPU with the same noise (phase 6's tolerance). (b) ``lvc_stack``
    at C = 16, 48 (padded), 64 and 128 in both dtypes at a 512-frame
    bucket's stages against its plain version (phase 14's holds), each
    launch equal to ``lvc_plan``. (c) A hidden-1024 acoustic model (8 heads
    of 128, filter 1024, 4 + 4 blocks) with HiFi-GAN V1 from seeded
    generators serves ``IW_TEXTS`` through ``generate_samples`` in bf16 and
    f32: ``ffn_ln.by_width`` must be {1024: every block of both passes};
    the f32 waveforms against the CPU's (phase 6's tolerance). (d)
    ``ffn_ln`` at C = 896, 1024, 2048 and 4096 against its plain version."""
    import dataclasses
    import shutil

    from lightningfastspeech2_tpu_torch.cli import generate as gen_cli
    from lightningfastspeech2_tpu_torch.cli import train as cli
    from lightningfastspeech2_tpu_torch.core.bucketing import pad_to
    from lightningfastspeech2_tpu_torch.core.config import lightspeech_flagship
    from lightningfastspeech2_tpu_torch.core.device import f32_convolutions
    from lightningfastspeech2_tpu_torch.data.synthetic import make_rich_corpus
    from lightningfastspeech2_tpu_torch.ops.fastdiff_lvc import lvc_stack
    from lightningfastspeech2_tpu_torch.ops.ffn import ffn_ln

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    work = ROOT / "_chip" / "inner_widths"
    shutil.rmtree(work, ignore_errors=True)
    parts_s = {}

    # (a) a joint checkpoint with FastDiff at 64 inner channels, served
    corpus = make_rich_corpus(work / "corpus", n_speakers=TC_SPEAKERS, n_utts=TC_UTTS, seed=0,
                              min_words=TC_WORDS[0], max_words=TC_WORDS[1])
    ck, logs = work / "ckpt", work / "logs"
    run = _train_cli(cli, ["--train_target_path", str(corpus), "--checkpoint_dir", str(ck),
                           "--log_dir", str(logs), "--cache_path", str(work / "cache"),
                           "--batch_size", "4", "--log_every", "1", "--num_workers", "0",
                           "--max_steps", str(IW_STEPS), "--checkpoint_every", str(IW_STEPS),
                           *IW_FLAGS], counters)
    lines = [l for l in _metrics_lines(logs) if "train/total_loss" in l]
    bad = [(l["step"], k) for l in lines for k, v in l.items()
           if k.startswith("train/") and not math.isfinite(v)]
    if len(lines) != IW_STEPS or bad or run["launches"]["lvc_stack"]:
        raise RuntimeError(f"FastDiff-64 train CLI: {len(lines)} steps, not finite {bad}, "
                           f"launches {run['launches']}")
    requests = {}
    for prec, name in (("16", "bf16"), ("32", "f32")):
        r = requests[name] = _serve(gen_cli, ck, work / f"out_{name}",
                                    ["--use_fastdiff", "true", "--vocoder_precision", prec],
                                    counters)
        r["lvc_by_width"] = dict(lvc_stack.by_width)
        if r["lvc_by_width"] != {64: 8}:
            raise RuntimeError(f"{name} FastDiff-64 request: lvc_stack by width "
                               f"{r['lvc_by_width']}, want {{64: 8}}")

    def cpu_noise(shape, N):
        g = torch.Generator().manual_seed(7)
        return torch.randn(tuple(shape), generator=g), torch.randn((N, *shape), generator=g)

    f32_convolutions(32)
    wavs, ms = {}, {}
    for d in ("cuda", "cpu"):
        args = gen_cli.build_parser().parse_args(
            ["--checkpoint_dir", str(ck), "--sentence", SENTENCES[0], "--output_path",
             str(work / f"ref_{d}"), "--seed", "0", "--use_fastdiff", "true", "--device", d])
        gen, gcfg, _ = gen_cli.load_generator(args)
        gen.synthesiser.noise_source = cpu_noise
        t = time.perf_counter()
        wavs[d] = gen_cli.synthesize_sentence(gen, gcfg, args)
        ms[d] = (time.perf_counter() - t) * 1e3
        del gen
    a, b = np.asarray(wavs["cuda"]), np.asarray(wavs["cpu"])
    peak = float(np.abs(b).max())
    ref_err = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
    ref_tol = 1e-3 * peak + 1e-7      # phase 6's: summation order through two models
    row_a = {"phase": "inner_widths_fastdiff64", "flags": IW_FLAGS, "cli_s": run["s"],
             "steps": len(lines), "losses": [l["train/total_loss"] for l in lines],
             "train_launches": run["launches"], "requests": requests,
             "reference": {"max_abs_err": ref_err, "tol": ref_tol, "peak": peak,
                           "samples": int(a.size), "request_ms": ms},
             "nvidia_smi": smi}
    emit(row_a)
    if not (a.shape == b.shape and ref_err <= ref_tol and peak > 0):
        raise RuntimeError(f"FastDiff-64 f32 request card vs CPU: max |err| {ref_err} > "
                           f"{ref_tol}")
    parts_s["a"] = time.perf_counter() - t_phase

    # (b) lvc_stack at every inner width against its plain version
    g = torch.Generator(device=dev).manual_seed(33)
    lvc_rows = {}
    for C in IW_LVC_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            for hop in IW_HOPS:
                r = lvc_rows[(C, str(dtype)[6:], hop)] = _lvc_case(dev, g, hop, dtype, C=C)
                # (a)'s request of the same dtype, at this width
                r["launches_phase_33"] = requests[str(dtype)[6:].replace("bfloat16", "bf16").replace(
                    "float32", "f32")]["lvc_by_width"].get(C, 0)
                torch.cuda.empty_cache()
    parts_s["b"] = time.perf_counter() - t_phase - sum(parts_s.values())

    # (c) a hidden-1024 acoustic model with HiFi-GAN V1 through generate_samples
    base = lightspeech_flagship()
    m = base.model
    enc = dataclasses.replace(m.encoder, hidden=IW_HIDDEN, heads=8, conv_filter_size=IW_HIDDEN)
    dec = dataclasses.replace(m.decoder, hidden=IW_HIDDEN, heads=8, conv_filter_size=IW_HIDDEN)
    cfg = dataclasses.replace(base, model=dataclasses.replace(m, encoder=enc, decoder=dec))
    m = cfg.model
    dvecs = served["dvecs"]
    blocks = 2 * m.encoder.layers + m.decoder.layers   # the duration pass, then the full one
    served_c, bias, batch = {}, None, None
    for dtype in (torch.bfloat16, torch.float32):
        # the duration bias taken on the card before the counts (bf16 run)
        gen, bias = _make_generator(cfg, dtype, None, dvecs, BATCH_TEXTS, bias)
        if batch is None:
            ids = [gen.text_to_ids(t) for t in IW_TEXTS]
            P = gen.bucketer.phone_bucket(max(len(i) for i in ids))
            batch = {"phones": np.stack([pad_to(i, P) for i in ids]),
                     "speaker": np.stack([dvecs[f"spk{j}"] for j in range(len(ids))])}
        reset_counts(counters)
        t = time.perf_counter()
        out = gen.generate_samples(batch)
        torch.cuda.synchronize()
        dt = str(dtype)[6:]
        served_c[dt] = {"ms": (time.perf_counter() - t) * 1e3,
                        "launches": {c.__name__: c.launches for c in counters if c.launches},
                        "ffn_by_width": dict(ffn_ln.by_width),
                        "samples": [int(w.size) for w in out]}
        if served_c[dt]["ffn_by_width"] != {IW_HIDDEN: blocks} or not all(
                w.size > 0 and np.isfinite(w).all() for w in out):
            raise RuntimeError(f"hidden-{IW_HIDDEN} {dt} batch: {served_c[dt]}, want ffn_ln "
                               f"by width {{{IW_HIDDEN}: {blocks}}}")
        if dtype == torch.float32:
            wav32 = out
        del gen
    gen, _ = _make_generator(cfg, torch.float32, "cpu", dvecs, BATCH_TEXTS, bias)
    t = time.perf_counter()
    cpu = gen.generate_samples(batch)
    cpu_ms = (time.perf_counter() - t) * 1e3
    del gen
    peak_c = max(float(np.abs(w).max()) for w in cpu)
    err_c = max((float(np.abs(x - y).max()) if x.shape == y.shape else float("inf"))
                for x, y in zip(wav32, cpu))
    tol_c = 1e-3 * peak_c + 1e-7
    row_c = {"phase": "inner_widths_hidden1024", "hidden": IW_HIDDEN, "heads": 8,
             "filter": IW_HIDDEN, "blocks": [m.encoder.layers, m.decoder.layers],
             "served": served_c, "duration_bias": bias,
             "reference": {"max_abs_err": err_c, "tol": tol_c, "peak": peak_c,
                           "cpu_ms": cpu_ms}, "nvidia_smi": smi}
    emit(row_c)
    if not err_c <= tol_c or peak_c <= 0:
        raise RuntimeError(f"hidden-{IW_HIDDEN} f32 batch card vs CPU: max |err| {err_c} > "
                           f"{tol_c}")
    parts_s["c"] = time.perf_counter() - t_phase - sum(parts_s.values())

    # (d) ffn_ln past C = 768 against its plain version
    g = torch.Generator().manual_seed(34)
    ffn_rows = []
    for C, B, T, F, k in IW_FFN:
        for dtype in (torch.bfloat16, torch.float32):
            r = _ffn_case(dev, B, T, k, dtype, g, C=C, F=F)
            r.update(channels=C, dtype=str(dtype)[6:],
                     launches_phase_33=served_c[str(dtype)[6:]]["ffn_by_width"].get(C, 0))
            ffn_rows.append(r)
            torch.cuda.empty_cache()
    parts_s["d"] = time.perf_counter() - t_phase - sum(parts_s.values())
    keys = ("at", "route", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "tol",
            "max_ulps", "unequal_share", "kernel_channels", "pad_copy_ms", "launch")
    tail = {"phase": "inner_widths",
            "lvc_stack": {f"C={C} {d} hop {h}": {k: r.get(k) for k in keys}
                          for (C, d, h), r in lvc_rows.items()},
            "ffn_ln": [{k: r.get(k) for k in keys} for r in ffn_rows],
            "parts_s": parts_s, "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    emit(tail)
    print(f"phase 33 (inner widths, serving FFN past 768): {tail['phase_s']:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return {"lvc": lvc_rows, "ffn": ffn_rows,
            "launches": {"lvc_stack": sum(sum(r["lvc_by_width"].values())
                                          for r in requests.values()),
                         "ffn_ln": sum(sum(r["ffn_by_width"].values())
                                       for r in served_c.values())},
            "lvc_by_width": {w: sum(r["lvc_by_width"].get(w, 0) for r in requests.values())
                             for w in sorted({w for r in requests.values()
                                              for w in r["lvc_by_width"]})},
            "ffn_by_width": {IW_HIDDEN: sum(r["ffn_by_width"][IW_HIDDEN]
                                            for r in served_c.values())}}


# ------- FastDiff past 128 inner channels, the training FFN past 768 (phase 34)
# the train CLI's flags of (a): the flagship with FastDiff at 256 inner
# channels, its kernel predictor at 8 hidden channels (at the reference's
# 64 its last convs alone hold 906M weights: the CLI run took 43.6 s and
# the CPU's request 29.9 s)
PW_FLAGS = ["--fastdiff_vocoder", "true", "--fastdiff_inner_channels", "256",
            "--fastdiff_kpnet_hidden", "8"]
PW_WORDS = (4, 8)                      # (a)'s corpus: short utterances, one a step
PW_REF_FRAME_STEP = 16                 # (b): the frame buckets of the card-vs-CPU pair
PW_LVC_WIDTHS = (192, 256, 512)        # (c): the wide route, 512-frame bucket
# (d): ffn_ln_train with its backward as a caller runs it, at the width
# past 768 the JAX fit estimate admits (F < C: no depthwise block builds it)
PW_CALL = (2, 256, 896, 768, 17)       # B, T, C, F, k
# (e): (C, F, k); bf16 at (B, T) = (8, 256), f32 at 2 x 512 rows
PW_FFN = ((896, 768, 17), (1024, 1024, 17), (2048, 2048, 17))
PW_FFN_SHAPES = {torch.bfloat16: (8, 256), torch.float32: (2, 512)}


def past_widths_phase(counters, smi: str) -> dict:
    """Phase 34: the last shapes the JAX kernels take past the port's
    earlier ones. (a) The train CLI on a corpus of short utterances, one
    bf16 step at batch 1 of the flagship with FastDiff at 256 inner
    channels (its plain training route: no ``lvc_stack`` launch), the peak
    device memory beside it; (b) the generate CLI with ``--use_fastdiff
    true`` on that checkpoint at ``--vocoder_precision`` 16 and 32:
    ``lvc_stack.by_width`` must read {256: 8} a request (the wide route);
    the f32 request on the card against the CPU's with the same noise
    (phase 6's tolerance), both at ``PW_REF_FRAME_STEP``-frame buckets. (c)
    ``lvc_stack`` at C = 192, 256 and 512 in both
    dtypes at a 512-frame bucket's stages against its plain version (phase
    14's holds), each launch equal to ``lvc_plan``. (d) ``ffn_ln_train``
    and its backward through autograd at ``PW_CALL`` (C = 896, F = 768,
    the width past 768 the JAX fit estimate admits) in bf16, as a caller
    runs them: launches by width {896: 1} each, the output and gradients
    finite. (e) ``ffn_ln_train`` at C = 896, 1024 and 2048 against its
    plain version (phase 32's holds), each launch against ``ffn_plan``."""
    import shutil

    from lightningfastspeech2_tpu_torch.cli import generate as gen_cli
    from lightningfastspeech2_tpu_torch.cli import train as cli
    from lightningfastspeech2_tpu_torch.core.device import f32_convolutions
    from lightningfastspeech2_tpu_torch.data.synthetic import make_rich_corpus
    from lightningfastspeech2_tpu_torch.ops.fastdiff_lvc import lvc_stack
    from lightningfastspeech2_tpu_torch.ops.ffn import ffn_ln_train, ffn_ln_train_bwd

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    work = ROOT / "_chip" / "past_widths"
    shutil.rmtree(work, ignore_errors=True)
    parts_s = {}

    # (a) a joint checkpoint with FastDiff at 256 inner channels, served
    corpus = make_rich_corpus(work / "corpus", n_speakers=2, n_utts=2, seed=0,
                              min_words=PW_WORDS[0], max_words=PW_WORDS[1])
    ck, logs = work / "ckpt", work / "logs"
    torch.cuda.reset_peak_memory_stats(dev)
    run = _train_cli(cli, ["--train_target_path", str(corpus), "--checkpoint_dir", str(ck),
                           "--log_dir", str(logs), "--cache_path", str(work / "cache"),
                           "--batch_size", "1", "--log_every", "1", "--num_workers", "0",
                           "--max_steps", "1", "--checkpoint_every", "1", *PW_FLAGS], counters)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"phase 34: FastDiff-256 train step at batch 1, peak device memory {peak_gb:.2f} GB",
          flush=True)
    lines = [l for l in _metrics_lines(logs) if "train/total_loss" in l]
    bad = [(l["step"], k) for l in lines for k, v in l.items()
           if k.startswith("train/") and not math.isfinite(v)]
    if len(lines) != 1 or bad or run["launches"]["lvc_stack"]:
        raise RuntimeError(f"FastDiff-256 train CLI: {len(lines)} steps, not finite {bad}, "
                           f"launches {run['launches']}")
    requests = {}
    for prec, name in (("16", "bf16"), ("32", "f32")):
        r = requests[name] = _serve(gen_cli, ck, work / f"out_{name}",
                                    ["--use_fastdiff", "true", "--vocoder_precision", prec],
                                    counters)
        r["lvc_by_width"] = dict(lvc_stack.by_width)
        if r["lvc_by_width"] != {256: 8}:
            raise RuntimeError(f"{name} FastDiff-256 request: lvc_stack by width "
                               f"{r['lvc_by_width']}, want {{256: 8}}")

    def cpu_noise(shape, N):
        g = torch.Generator().manual_seed(7)
        return torch.randn(tuple(shape), generator=g), torch.randn((N, *shape), generator=g)

    f32_convolutions(32)
    wavs, ms = {}, {}
    for d in ("cuda", "cpu"):
        args = gen_cli.build_parser().parse_args(
            ["--checkpoint_dir", str(ck), "--sentence", SENTENCES[0], "--output_path",
             str(work / f"ref_{d}"), "--seed", "0", "--use_fastdiff", "true", "--device", d])
        gen, gcfg, _ = gen_cli.load_generator(args)
        gen.synthesiser.noise_source = cpu_noise
        # both at PW_REF_FRAME_STEP-frame buckets: at the 256-frame bucket the
        # CPU's f32 FastDiff at 256 inner channels took 23.5 s
        gen.bucketer = dataclasses.replace(gen.bucketer, frame_step=PW_REF_FRAME_STEP)
        t = time.perf_counter()
        wavs[d] = gen_cli.synthesize_sentence(gen, gcfg, args)
        ms[d] = (time.perf_counter() - t) * 1e3
        del gen
    a, b = np.asarray(wavs["cuda"]), np.asarray(wavs["cpu"])
    peak = float(np.abs(b).max())
    ref_err = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
    ref_tol = 1e-3 * peak + 1e-7      # phase 6's: summation order through two models
    row_a = {"phase": "past_widths_fastdiff256", "flags": PW_FLAGS, "cli_s": run["s"],
             "steps": len(lines), "losses": [l["train/total_loss"] for l in lines],
             "train_peak_device_gb": peak_gb, "train_launches": run["launches"],
             "requests": requests,
             "reference": {"max_abs_err": ref_err, "tol": ref_tol, "peak": peak,
                           "samples": int(a.size), "request_ms": ms},
             "nvidia_smi": smi}
    emit(row_a)
    if not (a.shape == b.shape and ref_err <= ref_tol and peak > 0):
        raise RuntimeError(f"FastDiff-256 f32 request card vs CPU: max |err| {ref_err} > "
                           f"{ref_tol}")
    del run
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    parts_s["a"] = time.perf_counter() - t_phase

    # (c) lvc_stack on the wide route against its plain version
    g = torch.Generator(device=dev).manual_seed(34)
    lvc_rows = {}
    for C in PW_LVC_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype)[6:]
            for hop in IW_HOPS:
                r = lvc_rows[(C, dt, hop)] = _lvc_case(dev, g, hop, dtype, C=C)
                r["launches_phase_34"] = requests[
                    "bf16" if dtype == torch.bfloat16 else "f32"]["lvc_by_width"].get(C, 0)
                torch.cuda.empty_cache()
    parts_s["c"] = time.perf_counter() - t_phase - sum(parts_s.values())

    # (d) ffn_ln_train and its backward as a caller runs them, past C = 768
    B, T, C, F, k = PW_CALL
    g = torch.Generator().manual_seed(34)
    p = [(scale * torch.randn(*shape, generator=g) + shift).to(dev).requires_grad_(True)
         for shape, scale, shift in (((k, C), 0.3, 0.0), ((C,), 0.1, 0.0), ((C, F), C ** -0.5, 0.0),
                                     ((F,), 0.1, 0.0), ((F, C), F ** -0.5, 0.0), ((C,), 0.1, 0.0),
                                     ((C,), 0.1, 1.0), ((C,), 0.1, 0.0), ((C,), 0.1, 1.0),
                                     ((C,), 0.1, 0.0))]
    z = torch.randn(B, T, C, generator=g).to(dev, torch.bfloat16).requires_grad_(True)
    seed = torch.tensor([34], dtype=torch.int32, device=dev)
    reset_counts(counters)
    t = time.perf_counter()
    out = ffn_ln_train(z, p, seed, 0.1)
    grads = torch.autograd.grad(out, [z, *p], torch.randn_like(out))
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t) * 1e3
    by_width = {c.__name__: dict(c.by_width) for c in (ffn_ln_train, ffn_ln_train_bwd)}
    finite = bool(torch.isfinite(out).all()) and all(bool(torch.isfinite(x).all()) for x in grads)
    want = {n: {C: 1} for n in by_width}
    row_d = {"phase": "past_widths_train_call", "at": f"z ({B}, {T}, {C}) bf16, F={F}, k={k}",
             "call_ms_first": call_ms, "by_width": by_width, "finite": finite,
             "launches": {c.__name__: c.launches for c in counters if c.launches},
             "nvidia_smi": smi}
    emit(row_d)
    if by_width != want or not finite:
        raise RuntimeError(f"ffn_ln_train at C = {C}: {row_d}, want {want}")
    del p, z, out, grads
    parts_s["d"] = time.perf_counter() - t_phase - sum(parts_s.values())

    # (e) the training chain past C = 768 against its plain version
    g = torch.Generator().manual_seed(35)
    ffn_rows = {}
    for C, F, k in PW_FFN:
        for dtype, (B, T) in PW_FFN_SHAPES.items():
            r = ffn_rows[(C, F, str(dtype)[6:])] = _ffn_train_case(
                dev, B, T, k, g, dtype, C=C, F=F, timed=W_TIMED_MS, off_kink=True)
            for part in ("fwd", "bwd"):
                r[part]["launches_phase_34"] = by_width[r[part]["name"]].get(C, 0)
            torch.cuda.empty_cache()
    parts_s["e"] = time.perf_counter() - t_phase - sum(parts_s.values())
    keys = ("at", "route", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "tol",
            "max_ulps", "unequal_share", "kernel_channels", "pad_copy_ms", "launch")
    tail = {"phase": "past_widths",
            "lvc_stack": {f"C={C} {d} hop {h}": {k: r.get(k) for k in keys}
                          for (C, d, h), r in lvc_rows.items()},
            "ffn_ln_train": {f"{C}x{F} {d}": {p: {k: r[p].get(k) for k in keys}
                                              for p in ("fwd", "bwd")}
                             for (C, F, d), r in ffn_rows.items()},
            "parts_s": parts_s, "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    emit(tail)
    print(f"phase 34 (FastDiff past 128, training FFN past 768): {tail['phase_s']:.1f} s",
          flush=True)
    return {"lvc": lvc_rows, "ffn": ffn_rows,
            "launches": {"lvc_stack": sum(sum(r["lvc_by_width"].values())
                                          for r in requests.values()),
                         "ffn_ln_train": by_width["ffn_ln_train"][PW_CALL[2]],
                         "ffn_ln_train_bwd": by_width["ffn_ln_train_bwd"][PW_CALL[2]]},
            "lvc_by_width": {256: sum(r["lvc_by_width"][256] for r in requests.values())},
            "ffn_by_width": by_width}


def _summary(name, source, replaces, rows, launches) -> dict:
    """One kernels-line entry; several shapes add up to the stage's work."""
    keys = ("ms", "plain_ms", "bound_ms")
    out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": launches,
           "max_abs_err": max(r["max_abs_err"] for r in rows),
           **{k: sum(r[k] for r in rows) for k in keys},
           "bound_by": rows[-1]["bound_by"], "library_ms": None,
           "at": "; ".join(r["at"] for r in rows)}
    if len(rows) > 1:
        out["note"] = "ms, plain_ms and bound_ms add up the shapes listed in 'at'"
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a Hopper card",
              file=sys.stderr)
        return 1
    from lightningfastspeech2_tpu_torch.ops import attention as att

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    info = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    probe_row = probe_phase(dev)
    rows = kernels_phase(dev)
    counters = all_counters()
    for flag in ("LFS2_PALLAS_LR", "LFS2_FUSED_STAGE1"):
        if flag in os.environ:
            raise RuntimeError(f"run without {flag}: the script sets it for its own phases")
    served = serving_phase(counters)
    reference_phase(served)
    train_rows = train_kernels_phase(dev)
    trained = training_phase(counters)
    train_ref = train_reference_phase()
    sdtw_rows = sdtw_kernels_phase(dev)
    with env_opt_in("LFS2_PALLAS_LR"):
        sdtw_trained = training_phase(counters, soft_dtw=True)
        sdtw_ref = train_reference_phase(soft_dtw=True)
    # the two steps interleaved (l1, soft-DTW, l1, ...) so that a drift of
    # the host's speed during the run falls on both alike
    pairs = []
    for _ in range(STEP_PAIRS):
        l1_ms = trained["one_step"]()
        with env_opt_in("LFS2_PALLAS_LR"):
            pairs.append((l1_ms, sdtw_trained["one_step"]()))
    emit({"phase": "soft_dtw_step_vs_l1_step", "interleaved_pairs": STEP_PAIRS,
          "l1_step_ms": statistics.median(a for a, _ in pairs),
          "soft_dtw_step_ms": statistics.median(b for _, b in pairs),
          "difference_ms_median": statistics.median(b - a for a, b in pairs),
          "pairs_ms": pairs,
          "phase_means_ms": [trained["row"]["timed_step_ms_mean"],
                             sdtw_trained["row"]["timed_step_ms_mean"]],
          "profiled_soft_dtw_kernels_ms": sdtw_trained["split"]["soft_dtw_ms"]
          + sdtw_trained["split"]["soft_dtw_bwd_ms"],
          "profiled_regulate_kernels_ms": sdtw_trained["split"]["regulate_ms"]
          + sdtw_trained["split"]["regulate_bwd_ms"],
          "profiled_device_ms": sdtw_trained["split"]["device_ms"]})
    fd_rows = fastdiff_kernels_phase(dev)
    fd_served = fastdiff_serving_phase(counters, served)
    reference_phase({**served, "fastdiff_cfg": fd_served["cfg"]}, fastdiff=True)
    cli_rows = cli_phase(counters, info["nvidia_smi"])
    wide = wide_kernels_phase(dev)
    t76 = true76m_serving_phase(counters, served)
    t76_trained = true76m_training_phase(counters)
    fastspeech2_27m_phase(counters, served, info["nvidia_smi"])
    every_layer_phase(counters, served)
    head_dims = head_dim_training_phase(counters)
    dataset_phase(counters, info["nvidia_smi"])
    train_cli = train_cli_phase(counters, info["nvidia_smi"])
    joint = canonical_joint_phase(counters, info["nvidia_smi"])
    voc = hifigan_training_phase(counters, info["nvidia_smi"])
    odf = on_device_features_phase(counters, info["nvidia_smi"])
    dp = parallel_phase(counters, info["nvidia_smi"], train_cli["row"])
    b16 = b16_tools_phase(counters, served, info["nvidia_smi"])
    wide32 = wide_phase(counters, info["nvidia_smi"])
    inner = inner_widths_phase(counters, served, info["nvidia_smi"])
    past = past_widths_phase(counters, info["nvidia_smi"])
    # flash launches by route and head dim on the main paths' counted runs:
    # serving (phase 5), training (8, and its soft-DTW run), the f32 step
    # against the CPU (9, both losses), lightspeech_true76m training (21)
    main_dims = [served["flash_head_dims"], trained["row"]["flash_head_dims"],
                 sdtw_trained["row"]["flash_head_dims"], train_ref["flash_head_dims"],
                 sdtw_ref["flash_head_dims"], t76_trained["row"]["flash_head_dims"]]

    n = served["launches"]
    nt = trained["row"]["launches"]
    pkg = "lightningfastspeech2_tpu_torch/csrc"
    kernels = [
        {**{k: v for k, v in probe_row.items() if k != "tol"}, "launches": n["probe"]},
        # the served batch's decoder shape; the other shapes are on their
        # own lines above
        {**_summary("ffn_ln", f"{pkg}/ffn_ln.cu", "lightningfastspeech2_tpu/ops/pallas_ffn.py:77",
                    rows["ffn_ln"][:1], n["ffn_ln"]),
         # the f32 route at the generate CLI's request (phase 17)
         "cli_f32_request": cli_rows["f32"]["routes"]["ffn_ln_f32"]},
    ]
    # the bf16 route (the serving path's) summed over a 512-frame call's
    # launches, with the same chain through bf16 cuDNN convs; the f32 route
    # (split TF32: phase 6's request and phase 5's f32 call) summed the same
    # way beside it, with that call's resblock kernel time
    voc32 = served["vocoder_profile_f32"]
    for name, rep in (("resblock", "pallas_hifigan.py:103"),
                      ("resblock_trio", "pallas_hifigan.py:197")):
        rs = rows[name]
        r32 = [r for r in rows["resblock_f32"] if r["name"] == name]
        kernels.append({
            **_summary(name, f"{pkg}/resblock.cu", f"lightningfastspeech2_tpu/ops/{rep}",
                       rs, n[name]),
            "blocks_per_launch": [r["blocks_per_launch"] for r in rs],
            "tile": [r["tile"] for r in rs],
            "cudnn_bf16_chain_ms": sum(r["cudnn_bf16_chain_ms"] for r in rs),
            "f32_route": {
                "routes": [r["route"] for r in r32],
                "launches_a_512_frame_call": len(r32),
                **{k: sum(r[k] for r in r32)
                   for k in ("ms", "plain_ms", "bound_ms", "bound_ms_cuda_cores")},
                "max_abs_err": max(r["max_abs_err"] for r in r32),
                "plain": r32[0]["plain"], "bound_by": r32[-1]["bound_by"],
                "blocks_per_launch": [r["blocks_per_launch"] for r in r32],
                "tile": [r["tile"] for r in r32]},
            "f32_vocoder_call_resblock_ms": voc32["resblock_ms"],
            "f32_vocoder_call_resblock_launches": voc32["resblock_launches"]})
    # the training kernels at the first decoder block's shape (held against
    # the plain version there); the per-step sum over all eight FFN blocks
    # rides along
    dec = train_rows["ffn"][4]
    for part, src, rep in (("fwd", "ffn_ln.cu", "pallas_ffn.py:242"),
                           ("bwd", "ffn_ln_train_bwd.cu", "pallas_ffn.py:311")):
        r = dec[part]
        kernels.append({
            "name": r["name"], "route": "cuda", "source": f"{pkg}/{src}",
            "replaces": f"lightningfastspeech2_tpu/ops/{rep}", "launches": nt[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "at": r["at"], "launch_record": r["launch"],
            **({"chain_source": f"{pkg}/ffn_ln.cu"} if part == "bwd" else {}),
            "per_step_ms_all_8_blocks": sum(c[part]["ms"] for c in train_rows["ffn"]),
            "per_step_bound_ms_all_8_blocks": sum(c[part]["bound_ms"] for c in train_rows["ffn"]),
            # the f32 route (split TF32) summed over phase 9's eight shapes,
            # with that step's counted launches and profiled kernel time
            "f32_route": {
                **{k: sum(c[part][k] for c in train_rows["ffn_f32"])
                   for k in ("ms", "plain_ms", "bound_ms", "bound_ms_cuda_cores",
                             "products_matmul_ms")},
                "max_abs_err": max(c[part]["max_abs_err"] for c in train_rows["ffn_f32"]),
                "at": "; ".join(c[part]["at"] for c in train_rows["ffn_f32"]),
                "launches_phase_9_step": train_ref["ffn_launches"][r["name"]],
                "profiled_phase_9_step_ms": train_ref["profiled_step"][f"{r['name']}_ms"]}})
    # flash attention: the bf16 wgmma kernels (the training path's), then the
    # f32 split-TF32 kernels at phase 9's shape with that phase's launches
    for key, launches in (("flash", nt), ("flash_f32", train_ref["flash_routes"])):
        for part, rep in (("fwd", "pallas_attention.py:100"), ("bwd", "pallas_attention.py:128")):
            r = train_rows[key][part]
            counter = "flash_attention" + ("_bwd" if part == "bwd" else "")
            n = (launches[counter] if key == "flash" else launches[counter][r["route"]])
            kernels.append({
                "name": r["name"], "route": "cuda",
                "source": f"{pkg}/{att.LIBRARY[r['route']]}.cu",
                "replaces": f"lightningfastspeech2_tpu/ops/{rep}", "launches": n,
                **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "at", "build_s")},
                **{k: r[k] for k in ("library_fwd_bwd_ms", "split_bound_ms", "ms_rate0",
                                     "vs_library", "blocks_per_launch") if k in r}})
    ns = sdtw_trained["row"]["launches"]
    for key, src, reps in (("soft_dtw", "soft_dtw.cu", ("pallas_soft_dtw.py:81", "pallas_soft_dtw.py:112")),
                           ("regulate", "length_regulator.cu",
                            ("pallas_length_regulator.py:30", "pallas_length_regulator.py:66"))):
        for part, rep in zip(("fwd", "bwd"), reps):
            r = sdtw_rows[key][part]
            kernels.append({
                "name": r["name"], "route": "cuda", "source": f"{pkg}/{src}",
                "replaces": f"lightningfastspeech2_tpu/ops/{rep}", "launches": ns[r["name"]],
                **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "at")},
                **{k: r[k] for k in ("serial_diagonals", "library_fwd_bwd_ms", "event_ms",
                                     "kernels_a_call", "host_us", "library_event_ms") if k in r}})
    # lvc_stack at stage 3 of the served bucket in bf16; the other stages
    # and the f32 route (the generate CLI's default) ride along
    lvc_keys = ("at", "route", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "launch")
    kernels.append({
        **_summary("lvc_stack", f"{pkg}/lvc_stack.cu",
                   "lightningfastspeech2_tpu/ops/pallas_fastdiff.py:80", [fd_rows["stage3"]],
                   fd_served["launches"]["lvc_stack"]),
        **{name: {k: fd_rows[name][k] for k in lvc_keys}
           for name in ("stage2", "stage1", "stage3_pade", "stage3_f32", "stage2_f32",
                        "stage1_f32")},
        "vocoder_call_lvc_stack_ms": {"bf16": fd_served["split"]["lvc_stack_ms"],
                                      "f32": fd_served["split_f32"]["lvc_stack_ms"]}})
    # this slice's widths: ffn_wide_kernel at lightspeech_true76m's batch
    # shape (k = 17) with the bf16 serving run's launches, its f32 route and
    # every other shape riding along
    wide_keys = ("at", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "launch")
    bf, f32w = wide["ffn"][torch.bfloat16], wide["ffn"][torch.float32]
    kernels.append({
        **_summary("ffn_ln_wide", f"{pkg}/ffn_ln.cu (ffn_wide_kernel)",
                   "lightningfastspeech2_tpu/ops/pallas_ffn.py:77", [bf[4]],
                   t76["bfloat16"]["launches"]["ffn_ln"]),
        "f32_route": {**{k: f32w[4][k] for k in wide_keys},
                      "launches": t76["float32"]["launches"]["ffn_ln"]},
        "shapes": {"bf16": [{k: r[k] for k in wide_keys} for r in bf],
                   "f32": [{k: r[k] for k in wide_keys} for r in f32w]}})
    # flash attention past head dim 128: the launches the main paths' counted
    # runs made at this route and head dim (no preset has these head dims),
    # and phase 24's, a train step at each through the same entry point
    for (d, dt), case in wide["flash"].items():
        for part, rep_ in (("fwd", "pallas_attention.py:100"), ("bwd", "pallas_attention.py:128")):
            r = case[part]
            counter = "flash_attention" + ("_bwd" if part == "bwd" else "")
            key = f"{r['route']} d={d}"
            kernels.append({
                "name": r["name"], "route": "cuda",
                "source": f"{pkg}/{att.LIBRARY[r['route']]}.cu",
                "replaces": f"lightningfastspeech2_tpu/ops/{rep_}",
                "launches": sum(x[counter].get(key, 0) for x in main_dims),
                "launches_phase_24": sum(x["flash_head_dims"][counter].get(key, 0)
                                         for x in head_dims["rows"]),
                **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "at", "head_dim")}})
    # phase 26's counted CLI runs beside each kernel of their path: the
    # bf16 run's launches, the soft-DTW run's for soft-DTW and the regulator
    p26 = {**train_cli["row"]["launches"],
           **{k: train_cli["soft_dtw_launches"][k]
              for k in ("soft_dtw", "soft_dtw_bwd", "regulate", "regulate_bwd")}}
    for k in kernels:
        if k["name"] in p26 and "launches_phase_26" not in k:
            k["launches_phase_26"] = p26[k["name"]]
    # phase 27's counted runs (the canonical joint CLI runs and their
    # serving), summed
    for k in kernels:
        if k["name"] in joint["launches"] and "launches_phase_27" not in k:
            k["launches_phase_27"] = joint["launches"][k["name"]]
    # phase 28's counted serving runs (V1 and V2, f32 and bf16), and the
    # widths V2 added (C = 16, 8) at its request's lengths: the trio as
    # served, each resblock alone beside it
    narrow_keys = ("at", "route", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "tile",
                   "blocks_per_launch", "launches_v2_request")
    for k in kernels:
        if k["name"] in voc["launches"]:
            k["launches_phase_28"] = voc["launches"][k["name"]]
            k["c16_c8"] = {d: [{f: r[f] for f in narrow_keys} for r in rows if r["name"] == k["name"]]
                           for d, rows in voc["narrow"].items()}
    # phase 29's counted run (the train CLI from raw wavs, features in the
    # step)
    for k in kernels:
        if k["name"] in odf["launches"] and "launches_phase_29" not in k:
            k["launches_phase_29"] = odf["launches"][k["name"]]
    # phase 30's counted run (two ranks, the AdamW run), each rank's
    for k in kernels:
        if k["name"] in dp["launches"] and "launches_phase_30" not in k:
            k["launches_phase_30"] = {f"rank {i}": n
                                      for i, n in enumerate(dp["launches"][k["name"]])}
    # phase 31's counted serving runs (384 channels, bf16 and f32) and its
    # widths, each at the 512-frame bucket against its plain version
    b16_keys = ("at", "route", "channels", "kernel_channels", "ms", "plain_ms", "bound_ms",
                "bound_by", "max_abs_err", "tol", "tile", "blocks_per_launch", "pad_copy_ms",
                "direct_call_ms", "launches_phase_31")
    for k in kernels:
        if k["name"] in b16["launches"]:
            k["launches_phase_31"] = b16["launches"][k["name"]]
            k["b16_widths"] = {d: [{f: r.get(f) for f in b16_keys} for r in rows
                                   if r["name"] == k["name"]]
                               for d, rows in b16["widths"].items()}
    # phase 32: csrc/ffn_wide.cu's chain (training at C = 384-768 with the
    # hidden-512 CLI run's launches at the decoder's shape; every width
    # beside it) and serving at C = 768 (no preset serves it: 0 launches on
    # a main path), and csrc/resblock.cu's wide route at the 1024-channel
    # HiFi-GAN's stage 0 (its served requests' launches)
    wt = wide32["train"]
    part_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "at")
    for part, name, rep_ in (("fwd", "ffn_ln_train", "pallas_ffn.py:242"),
                             ("bwd", "ffn_ln_train_bwd", "pallas_ffn.py:311")):
        r = wt[(512, 1024, "bfloat16", TRAIN_T)][part]
        r32 = wt[(512, 1024, "float32", W_TRAIN_SHAPES[torch.float32][-1][1])][part]
        kernels.append({
            "name": f"{name}_wide", "route": "cuda", "source": f"{pkg}/ffn_wide.cu",
            "replaces": f"lightningfastspeech2_tpu/ops/{rep_}",
            "launches": wide32["launches"][name], **{k: r[k] for k in part_keys},
            "library_ms": None, "launch_record": r["launch"],
            "f32_route": {k: r32[k] for k in part_keys},
            "widths": {f"{C}x{F} {d} T={T}": {k: c[part][k] for k in part_keys}
                       for (C, F, d, T), c in wt.items()}})
    sv = wide32["serve_768"]
    kernels.append({
        **_summary("ffn_ln_c768", f"{pkg}/ffn_wide.cu", "lightningfastspeech2_tpu/ops/pallas_ffn.py:77",
                   sv[:1], wide32["launches"]["ffn_ln"]),
        "shapes": [{k: r[k] for k in ("at", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "max_abs_err", "launch")} for r in sv]})
    rw = wide32["resblock"]
    kernels.append({
        **_summary("resblock_wide", f"{pkg}/resblock.cu (wide_chain)",
                   "lightningfastspeech2_tpu/ops/pallas_hifigan.py:103",
                   [r for r in rw["bfloat16"] if r["channels"] == 512], wide32["launches"]["resblock"]),
        "widths": {d: [{k: r.get(k) for k in ("at", "ms", "plain_ms", "bound_ms", "bound_by",
                                               "max_abs_err", "launches_phase_32")} for r in rows]
                   for d, rows in rw.items()}})
    # phase 33: lvc_stack past C = 32 (its counted requests: FastDiff at 64
    # inner channels, bf16 and f32) and ffn_ln past C = 768 (the hidden-1024
    # model's counted batches), every width beside
    for k in kernels:
        if k["name"] in inner["launches"]:
            k["launches_phase_33"] = inner["launches"][k["name"]]
            if k["name"] == "lvc_stack":
                k["lvc_by_width"] = inner["lvc_by_width"]
    lvc_keys33 = ("at", "route", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                  "kernel_channels", "pad_copy_ms", "launches_phase_33")
    kernels.append({
        **_summary("lvc_stack_c64", f"{pkg}/lvc_stack.cu",
                   "lightningfastspeech2_tpu/ops/pallas_fastdiff.py:80",
                   [inner["lvc"][(64, "bfloat16", 256)]], inner["launches"]["lvc_stack"]),
        "lvc_by_width": inner["lvc_by_width"], "launches_phase_33": inner["launches"]["lvc_stack"],
        "widths": {f"C={C} {d} hop {h}": {k: r.get(k) for k in lvc_keys33}
                   for (C, d, h), r in inner["lvc"].items()}})
    kernels.append({
        **_summary("ffn_ln_c1024", f"{pkg}/ffn_wide.cu",
                   "lightningfastspeech2_tpu/ops/pallas_ffn.py:77",
                   [r for r in inner["ffn"] if (r["channels"], r["dtype"]) == (1024, "bfloat16")],
                   inner["launches"]["ffn_ln"]),
        "ffn_by_width": inner["ffn_by_width"], "launches_phase_33": inner["launches"]["ffn_ln"],
        "widths": [{k: r.get(k) for k in ("at", "ms", "plain_ms", "bound_ms", "bound_by",
                                          "max_abs_err", "launch", "launches_phase_33")}
                   for r in inner["ffn"]]})
    # phase 34: lvc_stack's wide route (its counted requests: FastDiff at 256
    # inner channels, bf16 and f32) and the training chain past C = 768 (the
    # hidden-1024 step's counted launches), every width beside
    for k in kernels:
        if k["name"] in past["launches"]:
            k["launches_phase_34"] = past["launches"][k["name"]]
    kernels.append({
        **_summary("lvc_stack_wide", f"{pkg}/lvc_stack.cu (wide route)",
                   "lightningfastspeech2_tpu/ops/pallas_fastdiff.py:80",
                   [past["lvc"][(256, "bfloat16", 256)]], past["launches"]["lvc_stack"]),
        "lvc_by_width": past["lvc_by_width"], "launches_phase_34": past["launches"]["lvc_stack"],
        "f32_route": {k: past["lvc"][(256, "float32", 256)][k]
                      for k in ("at", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
        "widths": {f"C={C} {d} hop {h}": {k: r.get(k) for k in lvc_keys33[:-1] + (
            "max_ulps", "unequal_share", "launches_phase_34")}
                   for (C, d, h), r in past["lvc"].items()}})
    for part, name, rep_ in (("fwd", "ffn_ln_train", "pallas_ffn.py:242"),
                             ("bwd", "ffn_ln_train_bwd", "pallas_ffn.py:311")):
        r = past["ffn"][(896, 768, "bfloat16")][part]
        kernels.append({
            "name": f"{name}_c896", "route": "cuda", "source": f"{pkg}/ffn_wide.cu",
            "replaces": f"lightningfastspeech2_tpu/ops/{rep_}",
            "launches": past["launches"][name], **{k: r[k] for k in part_keys},
            "library_ms": None, "launch_record": r["launch"],
            "ffn_by_width": past["ffn_by_width"][name],
            "launches_phase_34": past["launches"][name],
            "f32_route": {k: past["ffn"][(896, 768, "float32")][part][k] for k in part_keys},
            "widths": {f"{C}x{F} {d}": {k: c[part].get(k) for k in part_keys + ("launch",)}
                       for (C, F, d), c in past["ffn"].items()}})
    emit({"kernels": kernels})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-rank"]:
        sys.exit(cli_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--parallel"]:
        sys.exit(parallel_main(int(sys.argv[2])))
    sys.exit(main())
