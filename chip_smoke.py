"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:
1. card: needs CUDA; prints the card's name and power limit; TF32 off.
2. build: compiles the hand-written kernels from ``src/repro_torch/kernels/
   csrc`` with nvcc for sm_90a (one process per source); prints the build
   time and ptxas's report, per head dim the bf16 and f32 flash kernels'
   registers, spills and dynamic shared memory (the f32 one may spill at
   no head dim), the same per tile width (64, 128) and patch copy
   for the fused-conv kernel's f32 route and per tile width its bf16
   route (none may spill), per chunk (64, 128) for the SSD scan's
   three kernels, the mLSTM scan's four, the SSD scan backward's four and
   the mLSTM scan backward's six, and per head dim the flash backward's
   kernels on each route (bf16: the wgmma kernel at every head dim, its
   prep launch and its dq conversion, built for D <= 128 and for D = 256;
   f32: the prep launch and the one-pass kernel), none of which may
   spill.
3. kernel check: the fused-conv kernel (the tensor-core kernel of
   ``csrc/fused_conv_sm90.cu``: three bf16 wgmma products per f32 product,
   split K over a cluster) against its plain PyTorch version on the card,
   at every distinct conv shape of ResNet18 at batch 8, with the tile
   width and split of K the wrapper picks; a second launch must give the
   same bits.  Then the same shapes on the bf16 route (x, w and the
   residual in bf16: ``fused_conv_bf16_sm90_kernel``, one bf16 wgmma
   product per k-step, 64-deep k-blocks, no split pass; the stem's Cin = 3
   padded to 8 by the wrapper), every element
   within BF16_ULP·|plain| + KERNEL_RTOL·max|plain| of the plain version on
   the same operands, two launches bit-equal, every launch on that route.
4. model path: ResNet18 at the paper's width (224×224×3, 1000 classes,
   random weights from a seed) built through ``build_model`` serves 4
   requests of 8 images, then runs ``forward_fused_groups``; the logits are
   finite, the two forwards agree, the first request agrees with the plain
   forward on the CPU, and each forward made exactly 20 kernel launches,
   all on the f32 route.  Then ResNet18 in bf16 (the config with both
   dtypes bf16, as in JAX; the same weights as JAX's bf16 tree keeps them,
   BN statistics f32) serves the same requests in bf16 and runs
   ``forward_fused_groups``: 20 launches a forward, all on the bf16 route,
   finite bf16 logits, the fused groups bit-equal to the forward, and the
   first request held by BF16_DIST_FACTOR's rule against the f32 kernel
   forward of the same weights, beside the bf16 forward under
   ``ops.plain()``.
5. timings with CUDA events: per conv shape the tile and split, the
   kernel, its plain version, the library conv (``torch.nn.functional.
   conv2d`` without the epilogue, TF32 off; a yardstick only, the port never
   calls it), two bounds (the kernel's three bf16 products on the tensor
   cores, and the same f32 work on the CUDA cores) and TFLOP/s, and the
   kernel's and the library conv's device time from torch.profiler (the
   events time of a short call is its caller's host time); the forward;
   then device time by kernel and the idle share, from torch.profiler.
   The same per shape on the bf16 route (the library conv cuDNN's in bf16,
   the bounds one bf16 product on the tensor cores and the bf16 bytes),
   and the bf16 forward by CUDA events and device time.
6. halo: the paper's fused-layer dataflow on row shards (``repro_torch.
   core.halo``, one process, the shards in turn on the card), with the
   requests' parameters: ResNet18's three fused groups (stem + stage 1 in
   4 shards, stage 2 in 4, stage 3 in 2) each run with one halo exchange
   (the halo from ``group_halo_rows``, rounded up to the group's stride),
   batch 8 at 224², exactly 20, 20 and 10 fused_conv launches, every row
   within HALO_RTOL·max|plain| of the same sharded call under
   ``ops.plain()``; against the same group run whole: with more than two
   shards, rows outside the first and last shard within
   HALO_RTOL·max|whole| and deviating rows only in those two shards
   (their zero halo rows pass through BN's shift), printed for all;
   ``run_fused_group_exact`` on stage 1's four 3x3 convs as layers (4
   shards, halo 4), 16 launches, every row within the same limits of its
   plain sharded call and of the chain run whole;
   ``windowed_attention_halo`` at gemma2-2b's local layer (1x8192, 8 and
   4 heads of 256, window 4096, softcap 50, f32, 8 shards) against
   ``attention_scores`` over the whole sequence within FLASH_ATOL per
   element, no kernel launched, with the K/V bytes a gather and the halo
   move; CUDA-event times of each, sharded and whole, beside the card's
   name and power limit (none held).  Then the three fused groups in bf16
   on phase 4's bf16 net: 20, 20 and 10 launches, all on the bf16 route,
   each sharded call held by BF16_DIST_FACTOR's rule at any row against the
   f32 twin's sharded call beside the plain bf16 one, and against the
   group run whole by phase 6's row rule with the limit BF16_DIST_FACTOR
   times the plain call's distance.
7. flash check: the flash-attention kernels against their plain version on
   the card at gemma2-2b's head shapes (D=256, 8 query and 4 KV heads per
   batch row, softcap 50): S=8192 global and with the 4096 window, a ragged
   S=1000, B=4 at S=64 and a non-causal S=512, in bf16 (the tensor-core
   kernel), and a ragged, windowed S=1000 in f32 (the CUDA-core kernel);
   then small bf16 shapes at the other head dims (16, 32, 64, 128), and the
   same shapes and one at each of 80, 96 and 256 in f32 (the CUDA-core
   kernel at every head dim it is built for), each launched twice more
   with its statistics: outputs and log-sum-exps bit-equal, the
   log-sum-exp within FLASH_ATOL of the plain version's; every element
   within FLASH_RTOL·|plain| + FLASH_ATOL of the plain version computed in
   f32.
8. prefill: gemma2-2b at full width (26 layers, d 2304, vocab 256000,
   bf16, random weights from a seed) built through ``build_model`` runs
   ``forward`` at 1×8192; the logits are finite and of the right shape, the
   forward made exactly 26 flash launches, all on the tensor-core route
   (bf16 launches go there, f32 ones to the CUDA-core kernel; every path
   holds its launches by route), and it agrees with the same
   forward under ``ops.plain()`` (no launches) on the card: last-position
   logits within PREFILL_ATOL, top-1 equal wherever the plain top-2 margin
   exceeds it; the error at any position is printed too.
9. serve: ``ServeEngine.run_lockstep`` decodes 32 tokens for 4 prompts of
   64; each first token is the kernel-path forward's argmax (same margin
   rule).
10. timings: per flash shape the kernel, its plain version, the library's
   ``scaled_dot_product_attention`` (yardsticks the port never calls,
   without a softcap, so at softcap 50 they compute another function) with
   the boolean mask and, on the causal shapes without a window, with
   no mask and ``is_causal`` as the shape's (without a window), which can
   reach a faster backend (``library_ms`` is the faster of the two), and
   the bound; the prefill, with the flash
   kernel's share of device time and the idle share from torch.profiler;
   the decode step at batch 4, with its idle share.
11. scan check: the SSD-scan (mamba_scan) kernel (``csrc/
    mamba_scan_sm90.cu``: chunk states, state passing and chunk outputs,
    the products as three bf16 products on the tensor cores) against its
    plain version in f32 on the card at zamba2-2.7b's heads (H=80, P=64,
    N=64): the full prefill shape 1×4096, the same with long-memory decays
    (the state carried across every chunk), the serving prompts 4×64, a
    ragged S=1000 and the full-reset property (a_log = -30: y_t =
    (C_t·B_t)·dtx_t); every element within SCAN_ATOL, and a second launch
    gives the same bits.  ``ops.mamba_scan`` on bf16 operands at the
    serving shape: one launch, bf16 out (JAX's ops' dtype), within one bf16
    ulp of the plain version on the f32 copies plus SCAN_ATOL.
12. flash check at zamba2-2.7b's heads (D=80, 32 query and 32 KV heads, no
    softcap): S=4096 and B=4 at S=64 in bf16, a ragged S=1000 in f32, with
    the limits of phase 7; each launch moves only its dtype's route.
13. hybrid prefill: zamba2-2.7b at full width and depth (54 layers: 9 units
    of 5 Mamba2 blocks and one attention block, d 2560, vocab 32000, bf16,
    random weights from a seed) built through ``build_model`` runs
    ``forward`` at 1×4096; the logits are finite and of the right shape,
    the forward made exactly 45 mamba_scan and 9 flash launches (bf16, on
    the tensor-core route), and it
    agrees with the same forward under ``ops.plain()`` (no launches) by
    the rule of phase 8.
14. hybrid serve: ``run_lockstep`` decodes 32 tokens for 4 prompts of 64;
    each first token is the kernel-path forward's argmax (same rule).
15. f32 twin: phases 13 and 14 again for zamba2-2.7b at full width cut to
    one unit (6 layers: 5 mamba_scan and 1 flash launch, on the CUDA-core
    route), in f32, with the
    limit TWIN_ATOL held at every position.  This is the check that
    carries the hybrid's correctness; the bf16 phases show only that the
    full depth runs within bf16 noise.
16. timings: per scan shape the kernel, its plain version and the bounds
    (three bf16 products on the tensor cores against the bytes, and the
    f32 work on the CUDA cores; no single PyTorch call computes the scan,
    so no library time); per D=80
    flash shape as in phase 10; the hybrid prefill with each kernel's share
    of device time and the idle share; the decode step at batch 4.
17. mLSTM check: the mLSTM-scan (mlstm_scan) kernel (``csrc/
    mlstm_scan_sm90.cu``: the m chain and f64 scores, chunk carries, state
    passing and chunk outputs, the large products as three TF32 wgmma
    products) against its plain version in f32 on the card at xlstm-1.3b's
    heads (H=4, P=512): the full prefill shape 1×2048, the same with
    long-memory forget gates (f_pre N(0, 1) + 4: the state carried across
    every chunk), the serving prompts 4×64, a ragged S=1000, the
    forget-all shape (f_pre = -30: h_t = v_t (k_t·q_t) / max(|k_t·q_t|,
    1), also held against that closed form) and the stabiliser shape (i_pre
    ·10); every element within MLSTM_ATOL, and a second launch gives the
    same bits.  Each shape's distance of kernel and plain version from the
    recurrence in f64 is printed, not held.  ``ops.mlstm_scan`` on bf16 q,
    k, v at the serving shape as phase 11's bf16 case, with MLSTM_ATOL.
18. xLSTM prefill: xlstm-1.3b at full width and depth (48 layers: 12 units
    of 3 mLSTM blocks and one sLSTM block, d 2048, 4 heads of 512, vocab
    50304, bf16, random weights from a seed) built through ``build_model``
    runs ``forward`` at 1×2048; the logits are finite and of the right
    shape, and the forward made exactly 36 mlstm_scan launches and none of
    the other kernels.  Its distance from the same forward under
    ``ops.plain()`` is printed, not held (see the note under MLSTM_ATOL).
19. xLSTM serve: ``run_lockstep`` decodes 32 tokens for 4 prompts of 64;
    the first tokens against the forward's argmax are printed.
20. f32: the prefill of phase 18 again in f32 at full width cut to 24
    layers (18 mlstm_scan launches; XLSTM_F32_LAYERS), held to TWIN_ATOL
    at every position; then the f32 twin: phases 18 and
    19 for xlstm-1.3b at full width cut to one unit (4 layers: 3
    mlstm_scan launches), held to TWIN_ATOL at every position and in the
    engine.  These carry xLSTM's correctness.
21. timings: per mLSTM shape the kernel, its plain version and the bounds
    (the f64 scores at 67 TFLOP/s and the rest as three TF32 products at
    495, against the bytes; and all of it in f32 on the CUDA cores; no
    single PyTorch call computes the recurrence, so no library time);
    the xLSTM prefill; mlstm_scan's share of device time and the idle
    share from a profiled prefill of one unit at full width (4 layers:
    the full depth's ~10^6 profiler events took minutes to read); the
    decode step at batch 4.
22. flash check at the other decoder-only LMs' heads, with the limits of
    phase 7, each launch moving only its dtype's route: D=128 at
    deepseek-moe-16b's 16/16 heads (1×4096 and B=4 at S=64, bf16); D=96
    at phi3-mini-3.8b's 32/32 (1×4096 and B=4 at S=64 in bf16, a ragged
    S=1000 in bf16 and in f32); D=128 with GQA 64/8 at qwen3-32b's
    heads (S=512, bf16).  The build (phase 2) also holds both flash
    kernels' ptxas reports at D=96: no spills.
23. MoE prefill: deepseek-moe-16b at full width and depth (28 layers: a
    dense first layer and 27 MoE layers of 64 routed experts, top 6, and
    2 shared experts; d 2048, vocab 102400, bf16 with the f32 router,
    random weights from a seed, drawn on the host in a thread of its own
    beside phases 7-21 and moved to the card) built through
    ``build_model`` runs
    ``forward`` at 1×4096 (DeepSeekMoE's 4K training context); the
    logits are finite and of the right shape, and the forward made
    exactly 28 flash launches, all on the tensor-core route, and none of
    the other kernels.  Its distance from the same forward under
    ``ops.plain()`` is printed, not held (see MOE_TWIN_LAYERS), with the
    top-k selections that differ between the two runs and the dropped
    assignments, layer by layer.
24. MoE serve: ``run_lockstep`` decodes 32 tokens for 4 prompts of 64;
    each first token is held against the argmax of the kernel-path
    forward with ``moe_capacity_factor = E/K``, where the capacity is
    every token and nothing drops, by the rule of phase 8; the same
    against the forward at the config's 1.25 is printed, with its drops.
25. MoE f32 twin: deepseek-moe-16b at full width cut to the dense layer
    and 2 MoE layers, in f32, at 1×1024: 3 flash launches on the
    CUDA-core route, held to TWIN_ATOL at every position, and its engine
    against the no-drop forward at TWIN_ATOL.  This carries the MoE
    path's correctness; the smallest gap between the K-th and (K+1)-th
    router probability over all tokens and layers is printed.
26. configs: phi3-mini-3.8b, qwen3-32b, minicpm-2b and
    granite-moe-1b-a400m at full width cut to 2 layers, bf16, 1×4096,
    and paligemma-3b cut to 2 layers with 256 random prefix embeddings
    before 512 tokens: finite logits of the right shape, 2 flash
    launches each on the tensor-core route, and the dense ones held
    against ``ops.plain()`` by the rule of phase 8; granite's distance,
    flips and drops printed.
27. timings: per flash shape of phase 22 as in phase 10; the deepseek
    prefill with its device time split into flash, the routed experts'
    GEMMs, the other GEMMs, the MoE's routing, dispatch and combine, and
    the rest, and the idle share; the decode step at batch 4 with its
    idle share; each beside the card's name and power limit.
28. flash check at whisper-large-v3's heads (D=64, 20 query and 20 KV
    heads, no softcap), with the limits of phase 7, each launch moving only
    its dtype's route: bf16 at 4 clips, the encoder's bidirectional
    S=T=1500 (a ragged key tile of 92), the cross-attention's S=448 against
    T=1500 and the causal S=T=448; f32 at 1 clip, the first two.
29. encoder-decoder forward: whisper-large-v3 at full width and depth (32
    encoder and 32 decoder layers, d 1280, vocab 51866, bf16, random
    weights from a seed) built through ``build_model`` runs ``forward`` on
    4 clips of 1500 random frame embeddings (the conv frontend is a stub,
    as in JAX) and 448 tokens; the logits are finite and of the right
    shape, the forward made exactly 96 flash launches (32 encoder, 32
    self, 32 cross), all on the tensor-core route, and it agrees with the
    same forward under ``ops.plain()`` by the rule of phase 8 (every clip's
    last position).
30. encoder-decoder serve: 4 random clips through ``fill_cross_cache``
    (exactly 32 flash launches), then 64 prompt and 32 greedy tokens
    through ``decode_step`` (no launches); each first token is the argmax
    of the forward on the same prompts and clips (same rule).
31. timings: the forward with flash's share of device time and the idle
    share, the decode step at batch 4.
32. f32: the forward of phase 29 in f32 at full width and depth on one
    clip, 96 launches on the CUDA-core route, held to TWIN_ATOL at every
    position, and phase 30 in f32, its first tokens held wherever the
    margin exceeds TWIN_ATOL (in bf16 the random logits' margins rarely
    exceed 0.25); these carry the encoder-decoder's correctness.  Then
    ``examples/serve_lm_torch.py`` on the card (gemma2-2b-smoke through
    ``run_lockstep``, its first tokens equal to the forward's argmax).
33. timings: per flash shape of phase 28 as in phase 10, the library call
    being ``scaled_dot_product_attention`` with no mask and ``is_causal``
    as the shape's, which computes the same function (no softcap).
34. flash gradient: dq, dk and dv through ``ops.flash_attention`` on a
    tensor that needs a gradient (the kernel inside the ``FlashAttention``
    autograd function, whose backward launches the backward kernels:
    ``csrc/flash_attention_bwd_sm90.cu`` for bf16 at every head dim,
    ``csrc/flash_attention_bwd.cu`` for f32) against autograd of the plain
    attention in f32 on the same values, in bf16 and in f32, at
    minicpm-2b's 4x1024 with 36 heads of 64, qwen3's GQA 64/8 at D=128,
    gemma2's D=256 with window and softcap 50, zamba2's D=80 at 4x1024
    and a whisper-like non-causal cross shape (S=448, T=1500, D=64), and
    in bf16 at gemma2-2b's training layers (1x8192, 8/4 heads of 256,
    softcap 50, causal and with the 4096 window: phase 53's); each
    element within 1e-5·max|ref| (f32) or half a bf16 ulp + 2e-5 (bf16);
    each shape twice, the two gradients bit-equal, two forward and two
    backward launches, each on its dtype's (and head dim's) route.  From
    here on every
    check of a path's launches also holds the calls of the plain flash
    gradient (``ref.attention_ref_grad``, counted as
    ``plain_flash_backward``) at 0: no train step on the card reaches it.
35. training: minicpm-2b at full width and depth (40 layers, d 2304, 36
    heads of 64, d_ff 5760, vocab 122753, tied embeddings, bf16, random
    weights from a seed) takes 3 steps of ``make_train_step`` at 4x1024
    (``batch_for_step``), AdamW lr 3e-4 under WSD, and one with remat:
    exactly 40 flash and 40 flash backward launches a step on the
    tensor-core routes (80 forward with remat), finite loss and grad_norm, every leaf changed or its last
    update under half a bf16 ulp of every weight (the norms' 1.0 weights
    keep their bits at lr 3e-4), every leaf's gradient nonzero and finite;
    the peak device memory is printed.
36. f32 twin: minicpm-2b at full width cut to 2 layers in f32: one
    gradient and one step through the kernel path and under
    ``ops.plain()`` from the same state: loss within 1e-5 relative, every
    gradient leaf within 1e-4·max|g_plain|, the new parameters within 2·lr
    + 1e-6, every leaf changed; 2 flash and 2 flash backward launches on
    the CUDA-core routes.  This carries the training path's correctness.
37. restart: ``examples/train_lm_torch.py``'s default run (30 steps, a
    checkpoint every 10) uninterrupted and with a ``TransientError`` at
    step 12: per-step losses (the replayed step too) and the final state
    bit-equal, the loss falls; a flash and a flash backward launch a layer
    a step (f32).
38. timings (printed, not held): the step, tokens/s, the share of 6·N·
    tokens at 989 TFLOP/s, forward, backward and optimizer apart; a
    profiled step (flash's forward and backward kernels' shares of device
    time, the idle share); the attention at
    one layer's shape: the backward kernels alone against their bound and
    the plain f32 backward they replaced, and forward + backward against
    ``scaled_dot_product_attention``'s with ``is_causal`` (and its backward
    alone); the f32 backward kernels at the f32 twin's layer shape.
39. the SSD scan's backward kernel (``csrc/mamba_scan_bwd_sm90.cu``, under
    the ``MambaScan`` autograd function of ``ops.mamba_scan``) against
    autograd of the plain recurrence in f32 on the card, at zamba2's 4x1024
    (80 heads, P = N = 64), a full reset (a_log = -30) and long-memory
    decays: each gradient tensor within 1e-4·max|g_plain| (max|g_plain| at
    least 1e-6 of the shape's largest), one forward and one backward launch
    a call, two backward launches bit-equal; both gradients' distances
    from the gradient in f64 printed.
40. the same for the mLSTM scan's backward kernel
    (``csrc/mlstm_scan_bwd_sm90.cu``, ``MLSTMScan``) at xlstm's 4x512 (4
    heads of 512), forget-all (f_pre = -30) and long-memory gates; then
    each backward kernel's time per shape against its bound (the SSD
    scan's: the fewer operations of the adjoint recurrence and the chunked
    form as three bf16 products; the mLSTM scan's: the pairs' f64 scores
    at 67 TFLOP/s and their other products as three TF32 products at 495;
    each against the bytes) and the plain backward's at the training
    shape; no PyTorch call computes either gradient.
41. training: zamba2-2.7b at full width and depth (54 layers, bf16) takes 3
    steps at 4x1024 and one more, every one with remat (the plain step
    runs out of the card's 80 GB): exactly 90 mamba_scan, 45 backward, 18
    flash and 9 flash backward launches a step; loss, gradients and
    updates as phase 35.
42. f32 twin: zamba2-2.7b at full width cut to one unit (6 layers) at
    2x1024 against ``ops.plain()``, as phase 36.
43. timings of phase 41's step as in phase 38 (every part with remat),
    the profiled step's shares of the scan's and flash's forward and
    backward kernels.
44. training: xlstm-1.3b at full width cut to two units (8 layers,
    bf16; XLSTM_TRAIN_LAYERS, to keep the script within its budget: each
    unit's sLSTM loops over the steps on the host) takes one
    step at 4x512 and one with remat (XLSTM_TRAIN_STEPS): exactly 6
    mlstm_scan and 6 backward launches a step (12 forward with remat);
    then the f32 twin of one unit (4 layers) at 1x512 against
    ``ops.plain()``, as phase 36.
45. timings of phase 44's step as in phase 43; the
    profiled step is one unit's at full width (a step of all 48 layers
    records ~10^6 profiler events).
46. the launcher: ``python -m repro_torch.launch.train --arch minicpm-2b
    --mesh 1x1 --policy fused_seq`` (``launch.train.run`` in this process,
    on a one-rank NCCL group) at 4x1024 bf16, 4 steps, its state's leaves
    DTensors on the 1x1 mesh: at full width and depth without checkpoints
    (the machine's disk takes no two 27 GB states: LAUNCH_CUT_LAYERS), then
    at full width cut to 4 layers with a checkpoint every 2 and a
    ``TransientError`` at step 3, restored from step 2's checkpoint; each
    step exactly one flash and one flash backward launch a layer through
    the kernels' DTensor route, zero collective bytes (``launch/comm.py``), and each step's loss
    and the final parameters bit-equal to the plain-tensor trainer's from
    the same seed on the same batches.
47. ``layerwise_tp`` on the same state and batch: the loss bit-equal to
    ``fused_seq``'s, zero collective bytes, 40 flash and 40 backward
    launches (80 forward in a step with remat), none in a forward under
    ``ops.plain()``; then one step split
    into its gradient and AdamW (phase 49).
    Its table stays ``Shard(0)`` on the size-1 ``model`` dim and takes
    the masked lookup once a step (``core.dtensor.route_counts``).
48. the dry run as users run it, in subprocesses started before phase 46:
    ``python -m repro_torch.launch.dryrun --mesh single --cells
    minicpm-2b@prefill_32k,deepseek-moe-16b@prefill_32k`` under each
    policy (256 fake ranks, meta shards): exit 0, nothing computed
    replicated; per-device argument bytes, FLOPs and collective bytes by
    kind printed, deepseek's beside those of commit 6159077 (every rank
    running the whole MoE FFN).
49. time: the launcher's step (host clock, synchronised) beside the plain
    trainer's at the same shape, the difference being the launcher's
    overhead over the plain trainer; one step of each split into its
    gradient and its AdamW update, to say where that overhead lies.
50. the launcher on a MoE config: ``python -m repro_torch.launch.train
    --arch granite-moe-1b-a400m --mesh 1x1`` at full width and depth (24
    MoE layers, 32 experts, top-8, bf16), 4x1024, 4 steps, ``--ckpt-every
    0``, under ``fused_seq`` and then ``layerwise_tp``: every state leaf a
    DTensor, each step the expert-parallel MoE FFN once a layer and (under
    ``layerwise_tp``) the masked lookup once, 24 flash and 24 flash
    backward launches on the tensor-core routes, zero collective bytes in
    step 0; a forward of the
    final state under ``ops.plain()`` takes the same routes and launches
    nothing; each step's loss and the final parameters against the plain
    trainer from the same seed (bit-equal, or the loss within
    LAUNCH_LOSS_RTOL, and the run prints the first step that differs).
53. (run right after phase 34, phases 53-55 in order) training:
    gemma2-2b at full width and depth (26 layers, d 2304, 8
    query and 4 KV heads of 256, d_ff 9216, vocab 256000, bf16, attention
    softcap 50, final softcap 30, tied and scaled embeddings) on phase 8's
    weights, kept on the host since phase 10 rather than drawn again,
    takes 3 steps of ``make_train_step`` at 1x8192 (Gemma 2's training
    context, where the 13 local layers' 4096 window bites) and one more,
    every one with remat, AdamW lr 3e-4 under WSD: exactly 52 flash and
    26 flash backward launches a step on the tensor-core routes, the plain
    flash gradient never called; loss, gradients and updates as phase 35.
    Then the gradient without remat, which runs out of the card's 80 GB,
    printed with the memory it reached (why the steps take remat).
54. timings of phase 53's step as in phase 38 (the profiled step's
    shares of flash's forward and backward kernels and the idle share),
    and the bf16 backward kernels alone at both training layers against
    their bound and the plain f32 backward (none held).
55. f32 twin: gemma2-2b at full width cut to one local and one global
    layer, f32, at 1x4608 (the window bites past 4096) against
    ``ops.plain()``, as phase 36.
51. prints the ``kernels`` JSON line (the four kernels with the fused
    conv's bf16 route as ``fused_conv_bf16``, the flash backward on each
    route and the scans' two backward kernels), 52. the final ``{"ok": true, ...}`` line.  The full
    record goes to ``build/chip_smoke.json``, and the summary line ends
    with the script's total time.

    python3 chip_smoke.py --conv-times

times only the fused conv, at every conv shape of phase 3, with CUDA
events and on the card, through whatever ``src/repro_torch`` lies beside
this file: a copy of this file beside an older checkout times that
checkout's kernel the same way, for a comparison in one call.  Where the
checkout has the bf16 route it is timed too, as phase 5 times it.

    python3 chip_smoke.py --scan-times

does the same for the SSD scan at every shape of phase 11, at every chunk
the wrapper is built for: each shape first held against the plain version
(SCAN_ATOL, two launches bit-equal), then CUDA-event and device time, the
device time of each of the op's kernels, and the sums over one prefill.

    python3 chip_smoke.py --mlstm-times

does the same for the mLSTM scan at every shape of phase 17 (MLSTM_ATOL).

    python3 chip_smoke.py --flash-bwd-times

times the flash backward kernels alone at every shape of phase 34
(minicpm-2b's layer first, zamba2-2.7b's D=80 fourth), in bf16 and in f32,
beside their bound and SDPA's backward, then the f32 forward kernel beside
SDPA's f32 forward at the f32 twin's layer, whisper's f32 clip shapes and
phase 34's other head dims, through whatever ``src/repro_torch`` lies
beside this file, the same way.

    python3 chip_smoke.py --scan-bwd-times

times both scans' backward kernels alone at phase 39's and 40's shapes,
each first held against the plain gradient as there: CUDA events, each
device kernel's time, TFLOP/s and the bound, through whatever
``src/repro_torch`` lies beside this file, the same way.

    python3 chip_smoke.py --launch-paths

runs phases 46-50 alone after the build, and prints the script's time.

    python3 chip_smoke.py --xlstm-prefill-times

times xlstm-1.3b's bf16 prefill at 1×2048 alone, through whatever
``src/repro_torch`` lies beside this file, the same way.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 8
IMAGE_HW = 224
REQUESTS = 4
CONVS_PER_FORWARD = 20
# f32 sums taken in another order than the plain version's:
KERNEL_RTOL = 1e-4    # max|kernel − plain| ≤ KERNEL_RTOL · max|plain|, per conv
LOGITS_RTOL = 1e-3    # the same over 20 layers, GPU kernels vs plain on the CPU
FUSED_RTOL = 1e-6     # forward_fused_groups runs the same launches as forward
# The bf16 route (x, w and the residual bf16) against its plain version on
# the same bf16 operands (f32 sums, one rounding), per element:
# |kernel − plain| ≤ BF16_ULP·|plain| + KERNEL_RTOL·max|plain|.  The two
# f32 sums, taken in other orders, can round to bf16 on the two sides of a
# tie: one bf16 ulp, at most 2^-7 of the value.
BF16_ULP = 2.0**-7
# A bf16 path of several convs (the forward, a fused group) is held to the
# f32 kernel path of the same weights and input (the bf16 values upcast):
# its distance from it at most BF16_DIST_FACTOR times that of the same bf16
# path under ops.plain() (the same roundings, its convs by cuDNN in f32),
# and for logits top-1 equal to the plain path's wherever the f32 margin
# exceeds both distances: the rule tests/test_torch_resnet_bf16.py holds
# against JAX's bf16 forward.
BF16_DIST_FACTOR = 1.5
PEAK_F32_OPS = 67e12  # H100 SXM, f32 outside the tensor cores, per second
PEAK_BF16_OPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
PEAK_TF32_OPS = 495e12  # H100 SXM, dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes per second
TIMING_ITERS = 20
PROFILE_FORWARDS = 5

# The halo dataflow (``repro_torch.core.halo``), on the requests' params and
# first batch.  Per fused group of ResNet18 (plan_fused(graph, 2, 2)): the
# shards, and the fused-conv launches that many shards make (5 convs each).
# Each halo is group_halo_rows at those tiles rounded up to a multiple of
# the group's stride (the crop is aligned only then), shrink = halo/stride.
# The sharded group is held at every row against the same sharded call under
# ops.plain() within HALO_RTOL·max|plain| (the conv check's limit: each
# shard's M gets its own tile and split), and, with more than two shards,
# against the group run whole: rows outside the first and last shard within
# HALO_RTOL·max|whole|, deviating rows only in those two shards (zero halo
# rows through BN's shift).
HALO_SHARDS = (4, 4, 2)
HALO_LAUNCHES = (20, 20, 10)
HALO_RTOL = KERNEL_RTOL
# run_fused_group_exact on stage 1's four 3x3 convs as separate layers
# (conv + folded BN + ReLU, no residual), held at every row.
EXACT_SHARDS, EXACT_HALO, EXACT_LAUNCHES = 4, 4, 16
# windowed_attention_halo at gemma2-2b's local layer, f32, against
# attention_scores over the whole sequence, per element within FLASH_ATOL.
SEQ_HALO_S, SEQ_HALO_SHARDS = 8192, 8
HALO_ITERS = 10

# gemma2-2b serving.  Flash kernel vs plain, on N(0, 1) inputs, element by
# element: |kernel − plain| ≤ FLASH_RTOL·|plain| + FLASH_ATOL, with the
# plain version run in f32 on the same inputs (bf16 inputs upcast, no
# rounding of its output).  Both kernels keep f32 statistics and sums (the
# bf16 one multiplies bf16 values exactly on the tensor cores and carries
# P as hi + lo bf16, within 2**-17 of f32), so what is left is reordered
# f32 sums (FLASH_ATOL, the f32 limit of tests/test_kernels.py) and, for
# bf16, the one rounding of its output: half a bf16 ulp, at most 2**-8 of
# the value.  Outputs shrink as 1/sqrt(visible keys) along S, so a
# flat limit would let a late row's dropped key tile pass; this one does not.
FLASH_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0**-8}
FLASH_ATOL = 2e-5
LM_CONFIG = "gemma2-2b"
PREFILL_S = 8192         # longer than the 4096 window of the local layers
# The prefill in bf16 against its plain self: the kernel and the plain
# version round the attention output to bf16 at different ties, and 26
# layers carry that on.  Logits of these random weights are about N(0, 1)
# (final norm × 0.02-scale tied embedding), so this allows 32 bf16 ulps
# (2**-7) of a logit of size 1.
PREFILL_ATOL = 0.25
SERVE_BATCH, PROMPT_LEN, NEW_TOKENS = 4, 64, 32
FLASH_BIG_ITERS = 5      # timing launches at S>=4096 (ms to tens of ms each)

# (name, launches per prefill forward, batch, S, causal, window, dtype)
# at gemma2-2b's heads: 8 query heads over 4 KV heads per batch row,
# head dim 256, softcap 50, S = T.  The prefill runs the first two, 13
# layers each (window 0 on odd layers, 4096 on even ones).
FLASH_SHAPES = [
    ("s8192_global_bf16", 13, 1, 8192, True, 0, torch.bfloat16),
    ("s8192_window4096_bf16", 13, 1, 8192, True, 4096, torch.bfloat16),
    ("s1000_ragged_bf16", 0, 1, 1000, True, 0, torch.bfloat16),
    ("b4_s64_bf16", 0, 4, 64, True, 0, torch.bfloat16),
    ("s512_noncausal_bf16", 0, 1, 512, False, 0, torch.bfloat16),
    ("s1000_ragged_window300_f32", 0, 1, 1000, True, 300, torch.float32),
]
# The tensor-core kernel's other builds, in bf16 with the limits above:
# (name, BH, BKV, S, T, head dim, causal, window, softcap).
FLASH_HEAD_DIM_SHAPES = [
    ("d16_s300_group2_window64", 4, 2, 300, 300, 16, True, 64, 50.0),
    ("d32_s257_t191_noncausal", 6, 3, 257, 191, 32, False, 0, 30.0),
    ("d64_s200_group8", 8, 1, 200, 200, 64, True, 0, 0.0),
    ("d128_s333_window128", 8, 4, 333, 333, 128, True, 128, 50.0),
]
# The CUDA-core kernel's builds, in f32 with the limits above (rtol 0), its
# statistics too and two launches bit-equal: the shapes above and one at
# each other head dim.
FLASH_F32_HEAD_DIM_SHAPES = FLASH_HEAD_DIM_SHAPES + [
    ("d80_s300_t257_group4", 8, 2, 300, 257, 80, True, 0, 0.0),
    ("d96_s257_noncausal_window100", 6, 3, 257, 257, 96, False, 100, 30.0),
    ("d256_s333_group2_window128", 4, 2, 333, 333, 256, True, 128, 50.0),
]

# zamba2-2.7b serving: the SSD-scan kernel, flash at D=80 and the hybrid path.
HYBRID_CONFIG = "zamba2-2.7b"
HYBRID_PREFILL_S = 4096
# The scan kernel vs its plain version, both f32 on the card, element by
# element: |kernel − plain| ≤ SCAN_ATOL, the 1e-4 of tests/test_kernels.py.
# Inputs are drawn as that file draws them (dtx·0.3, a_log = −softplus(N(0,
# 1)), B and C ·0.3), so |y| reaches about 3.6 at N = 64.  The kernel sums
# each chunk's products in another order than the plain step-by-step
# recurrence, takes e^{Σa} where the recurrence multiplies up to 128
# factors e^{a}, and takes each product as three bf16 products (hi·hi +
# hi·lo + lo·hi), within a few 2^-16 of the product: a CPU emulation of its
# arithmetic puts y within 5.1e-5 of f64 at these shapes
# (tests/test_torch_mamba_scan.py), the largest products, the diagonal
# (C_t·B_t)·dtx_t, setting the error.  Errors do not pile up along S: the
# state's error is a few 2^-16 of the state, and the state forgets.
SCAN_ATOL = 1e-4
# The long-memory shape: a_log = −Δ·A with Δ log-uniform in [1e-3, 0.1]
# per step and head (the Mamba2 paper's range for Δ, arXiv:2405.21060) and
# A = linspace(1, 16) over the heads (the model's init, models/ssm.py), so
# the slow heads carry the state across every chunk (e^{A_c} ≈ 0.06 a
# chunk of 128 at A = 1) and a state pass that drops or misroutes the
# carried state misses the limit by orders of magnitude (0.5 in the
# emulation).  |y| reaches about 6.5; the kernel's error is no larger than
# at the fast draws (5.0e-5 in the emulation), since each chunk's state
# carries only the relative error of its products, and the plain f32
# recurrence is within 1.2e-6 of f64 there.  So the same limit holds.
LONG_DT = (1e-3, 0.1)
LONG_A = (1.0, 16.0)
SCAN_CHUNK = 128         # the kernel's chunk at S > 256 (mamba_scan.chunk_for),
                         # for counting its operations
# (name, launches per prefill forward, batch, S, a_log: None for
# −softplus(N(0, 1)), "long" for the long-memory draw, else that constant)
# at zamba2's H=80 heads of P=64, N=64.  The prefill runs the first, once
# per Mamba2 layer.
SCAN_SHAPES = [
    ("b1_s4096", 45, 1, 4096, None),
    ("b1_s4096_long_memory", 0, 1, 4096, "long"),
    ("b4_s64", 0, 4, 64, None),
    ("b1_s1000_ragged", 0, 1, 1000, None),
    ("b1_s256_reset", 0, 1, 256, -30.0),
]
# Flash at zamba2's heads: 32 query and 32 KV heads of 80, no softcap, S = T.
# The prefill runs the first, once per attention block.
HYBRID_FLASH_SHAPES = [
    ("s4096_d80_bf16", 9, 1, 4096, True, 0, torch.bfloat16),
    ("b4_s64_d80_bf16", 0, 4, 64, True, 0, torch.bfloat16),
    ("s1000_ragged_d80_f32", 0, 1, 1000, True, 0, torch.float32),
]
# The hybrid prefill against its plain self is held to PREFILL_ATOL, for the
# reason given there: the kernels and the plain versions differ only in the
# order of f32 sums, which shows as bf16 rounding at other ties in the scan
# and attention outputs, carried on by the layers.  Its logits are about
# N(0, 1) too (final norm × 0.02-scale tied embedding over d = 2560).  So
# that a fault cannot hide in that bf16 noise, an f32 twin (full width, one
# unit: 5 Mamba2 layers and an attention block) is held to TWIN_ATOL at
# every position: the scan's reordering error is some 4e-6 of |y| (exp of
# summed log decays against a product of exps, up to 64 terms), the flash
# kernel's 1e-6, and 6 layers carry that to 1e-5 of logits of size 1–5.
# Its serving engine's first tokens must equal the forward's argmax wherever
# the margin exceeds TWIN_ATOL, which in f32 is nearly everywhere.
TWIN_ATOL = 1e-3

# xlstm-1.3b serving: the mLSTM-scan kernel and the xLSTM path.
XLSTM_CONFIG = "xlstm-1.3b"
# 2048 is the context length at which the xLSTM paper trained its 1.3B
# models (arXiv:2405.04517, section 4.3).
XLSTM_PREFILL_S = 2048
# Phase 20's f32 prefill: full width, half the depth (6 of 12 units).  Its
# plain forward, the sLSTM's host loop over 2048 steps a layer, took 40 s at
# full depth on a slower host; the one-unit twin holds the same path too.
XLSTM_F32_LAYERS = 24
# The mLSTM kernel vs its plain version, both f32 on the card, element by
# element: |kernel − plain| ≤ MLSTM_ATOL, the 1e-4 of tests/test_kernels.py.
# Inputs are drawn as that file draws them (q, k, v ·0.4, i_pre N(0, 1),
# f_pre N(0, 1) + 2), so at P = 512 the dot products k·q reach ~15 and |h|
# ~15-20 (1.8 in the JAX test at P = 16): the same limit is ~10x tighter
# relative to the output here.  The kernel runs the plain version's m chain
# in its order and takes its per-step exponents, so what is left is f32
# sums in another order: chunk sums on the tensor cores (three TF32
# products per f32 product) where the plain version steps, and the
# denominator n·q, which cancels, from scores in f64.
MLSTM_ATOL = 1e-4
# The bf16 xLSTM prefill and serve are printed against their plain selves,
# not held to PREFILL_ATOL.  Measured on an H100: fed the same input, a
# bf16 mLSTM block of the kernel path and of the plain path differ by one
# bf16 ulp of the residual stream (their f32 scan outputs, within 5e-6 of
# each other at |h| ~ 10, round to bf16 at other ties), and this
# random-weight network amplifies a perturbation about 1000-fold over its
# 48 layers (in f32: 4e-6 after the first block, 6e-3 after the last), so
# the bf16 logits of the two paths end 0.7 apart at the last position and
# 1.5 at some position, noise that no limit can separate from a fault.
# The same path in f32 at full width and depth is held to TWIN_ATOL at
# every position instead (0.8e-3 measured), and the one-unit f32 twin also
# holds the serving engine.
# A CPU emulation of the kernel's arithmetic holds 1e-4 against the JAX
# oracle on the usual, stabiliser and long-memory draws
# (tests/test_torch_mlstm_scan.py).  The plain version is no closer to exact:
# on some long-memory draws its own f32 sums drift from the recurrence in
# f64 by about the limit, so each shape prints both distances from f64.
MLSTM_CHUNKS = tuple(2**i for i in range(10))   # chunked forms counted
# (name, launches per prefill forward, batch, S, f_pre: None for N(0, 1) +
# 2, "long" for N(0, 1) + 4, else that constant, i_pre scale) at
# xlstm-1.3b's H=4 heads of P=512.  The prefill runs the first, once per
# mLSTM layer.
MLSTM_SHAPES = [
    ("b1_s2048", 36, 1, 2048, None, 1.0),
    ("b1_s2048_long_memory", 0, 1, 2048, "long", 1.0),
    ("b4_s64", 0, 4, 64, None, 1.0),
    ("b1_s1000_ragged", 0, 1, 1000, None, 1.0),
    ("b1_s256_forget_all", 0, 1, 256, -30.0, 1.0),
    ("b1_s512_stabiliser", 0, 1, 512, None, 10.0),
]

# deepseek-moe-16b serving: the MoE FFN (plain PyTorch, as JAX leaves it to
# XLA), flash at D=128, and the other decoder-only LMs with flash at D=96.
MOE_CONFIG = "deepseek-moe-16b"
# DeepSeekMoE's 4K training context (arXiv:2401.06066).
MOE_PREFILL_S = 4096
# The bf16 MoE prefill against its plain self is printed, not held: a
# one-ulp bf16 difference of the residual stream moves the router
# logits by about 1e-3, some of the 4096 tokens' top-k gaps in 27 layers
# are smaller, and a token routed to another expert moves its row and,
# through the later attention layers, the rows after it; the JAX semantics
# do the same.  An f32 twin at full width, cut to the dense layer and two
# MoE layers, is held to TWIN_ATOL at every position instead: its
# perturbation is about 1e-6, below nearly every gap (the smallest gap is
# printed, so that a miss can be told from a fault).  Its engine is held
# against the forward at ``moe_capacity_factor = E/K``: at the config's
# 1.25 a 4×64 forward drops assignments (C = 30 against a mean load of
# 24) where a batch-4 decode step never does (C = 6), so forward and
# decode differ by the JAX semantics (tests/test_arch_smoke.py leaves MoE
# configs out of its forward-vs-decode test).
MOE_TWIN_LAYERS = 3
MOE_TWIN_S = 1024
# (name, launches per prefill forward, batch, S, causal, window, dtype) at
# deepseek-moe-16b's heads: 16 query and 16 KV heads of 128, no softcap.
# The prefill runs the first, once per layer.
MOE_FLASH_SHAPES = [
    ("s4096_d128_bf16", 28, 1, 4096, True, 0, torch.bfloat16),
    ("b4_s64_d128_bf16", 0, 4, 64, True, 0, torch.bfloat16),
]
# At phi3-mini-3.8b's heads: 32 and 32 of 96.  Its 2-layer prefill in
# phase 26 runs the first twice.
PHI3_FLASH_SHAPES = [
    ("s4096_d96_bf16", 2, 1, 4096, True, 0, torch.bfloat16),
    ("b4_s64_d96_bf16", 0, 4, 64, True, 0, torch.bfloat16),
    ("s1000_ragged_d96_bf16", 0, 1, 1000, True, 0, torch.bfloat16),
    ("s1000_ragged_d96_f32", 0, 1, 1000, True, 0, torch.float32),
]
# At qwen3-32b's heads: 64 query heads over 8 KV heads of 128.
QWEN3_FLASH_SHAPES = [
    ("s512_d128_gqa8_bf16", 0, 1, 512, True, 0, torch.bfloat16),
]
# (config, S, prefix embeddings), each at full width cut to CONFIG_LAYERS.
CONFIG_LAYERS = 2
CONFIG_RUNS = [("phi3-mini-3.8b", 4096, 0), ("qwen3-32b", 4096, 0),
               ("minicpm-2b", 4096, 0), ("granite-moe-1b-a400m", 4096, 0),
               ("paligemma-3b", 512, 256)]

# whisper-large-v3 serving: the encoder-decoder, and flash at D=64 in the
# two regimes that no other path runs: bidirectional over 1500 frames, and
# cross-attention with S != T.
WHISPER_CONFIG = "whisper-large-v3"
WHISPER_ROWS = 4          # clips (30 s of audio each) per bf16 forward
WHISPER_TOKENS = 448      # whisper's decoder context (n_text_ctx)
# (name, launches per bf16 forward, batch, S, causal, window, dtype, T) at
# whisper's 20 query and 20 KV heads of 64, no softcap.  The bf16 forward
# at 4 clips runs each of the first three once per layer: the encoder's
# bidirectional attention over 1500 frames (11 key tiles of 128 and a
# ragged 92), the decoder's cross-attention of 448 tokens to them (every
# query tile walks all 12 key tiles) and its causal self-attention.  The
# f32 forward at 1 clip runs the last two shapes once per layer each.
WHISPER_FLASH_SHAPES = [
    ("b4_s1500_enc_d64_bf16", 32, 4, 1500, False, 0, torch.bfloat16, 1500),
    ("b4_s448_t1500_cross_d64_bf16", 32, 4, 448, False, 0, torch.bfloat16,
     1500),
    ("b4_s448_causal_d64_bf16", 32, 4, 448, True, 0, torch.bfloat16, 448),
    ("b1_s1500_enc_d64_f32", 0, 1, 1500, False, 0, torch.float32, 1500),
    ("b1_s448_t1500_cross_d64_f32", 0, 1, 448, False, 0, torch.float32,
     1500),
]

# Distinct convs of ResNet18 at 224²: (name, launches per forward, input hw,
# Cin, Cout, k, stride, padding, relu, residual).  Stage n's first block has
# conv1 at stride 2, the downsample, and conv2 with the ADD_RELU epilogue;
# its second block has conv1 and conv2 at stride 1.
CONV_SHAPES = [("stem_7x7s2", 1, 224, 3, 64, 7, 2, 3, True, False),
               ("s1_3x3", 2, 56, 64, 64, 3, 1, 1, True, False),
               ("s1_3x3_add", 2, 56, 64, 64, 3, 1, 1, True, True)]
for _si, (_hw, _cin, _cout) in enumerate([(56, 64, 128), (28, 128, 256),
                                          (14, 256, 512)], start=2):
    _s = f"s{_si}"
    CONV_SHAPES += [
        (f"{_s}_3x3s2", 1, _hw, _cin, _cout, 3, 2, 1, True, False),
        (f"{_s}_down_1x1s2", 1, _hw, _cin, _cout, 1, 2, 0, False, False),
        (f"{_s}_3x3", 1, _hw // 2, _cout, _cout, 3, 1, 1, True, False),
        (f"{_s}_3x3_add", 2, _hw // 2, _cout, _cout, 3, 1, 1, True, True)]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def cuda_ms(fn, iters: int = TIMING_ITERS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_modules() -> dict:
    """Each kernel's wrapper module, whose ``launches`` counts its launches."""
    from repro_torch.kernels import (flash_attention, fused_conv, mamba_scan,
                                     mlstm_scan)
    return {"fused_conv": fused_conv, "flash_attention": flash_attention,
            "mamba_scan": mamba_scan, "mlstm_scan": mlstm_scan}


def zero_launches() -> None:
    from repro_torch.core.dtensor import route_counts
    route_counts.update(dict.fromkeys(route_counts, 0))
    PLAIN_FLASH_GRAD_CALLS[0] = 0
    for mod in kernel_modules().values():
        mod.launches = 0
        if hasattr(mod, "backward_launches"):
            mod.backward_launches = 0
    for mod, name in ((kernel_modules()["flash_attention"],
                       "launches_by_kernel"),
                      (kernel_modules()["fused_conv"], "launches_by_route")):
        routes = getattr(mod, name)
        for route in routes:
            routes[route] = 0


def flash_route(cfg) -> str:
    """The flash kernel that serves ``cfg``'s activations: the tensor-core
    kernel for bf16, the CUDA-core kernel for f32."""
    return "wgmma_bf16" if cfg.dtype == "bfloat16" else "simt_f32"


def launch_counts() -> dict[str, int]:
    """Each kernel's launches, the backward kernels as ``<op>_bwd``, and
    the calls of the plain flash gradient as ``plain_flash_backward``
    (``count_plain_flash_backward``)."""
    counts = {}
    for name, mod in kernel_modules().items():
        counts[name] = mod.launches
        if hasattr(mod, "backward_launches"):
            counts[f"{name}_bwd"] = mod.backward_launches
    counts["plain_flash_backward"] = PLAIN_FLASH_GRAD_CALLS[0]
    return counts


# Calls of ref.attention_ref_grad since zero_launches, once
# count_plain_flash_backward has wrapped it.
PLAIN_FLASH_GRAD_CALLS = [0]


def count_plain_flash_backward() -> None:
    """Wraps ``ref.attention_ref_grad``, the plain gradient that
    ``FlashAttention``'s backward takes for CPU tensors, in a counter that
    ``launch_counts`` reports as ``plain_flash_backward``; every
    ``check_launches`` holds it at 0 unless told otherwise, so each train
    step, gradient and launcher step checked shows that no step on the card
    reached the plain gradient.  The unwrapped function stays reachable as
    ``.plain`` (phase 38's yardstick)."""
    from repro_torch.kernels import ref
    grad = ref.attention_ref_grad
    if hasattr(grad, "plain"):
        return

    def counted(*args, **kw):
        PLAIN_FLASH_GRAD_CALLS[0] += 1
        return grad(*args, **kw)
    counted.plain = grad
    ref.attention_ref_grad = counted


def train_expect(flash: int, **others: int) -> dict[str, int]:
    """A train step's (or gradient's) launches: ``flash`` flash forwards
    and as many backward launches, and ``others``."""
    return {"flash_attention": flash, "flash_attention_bwd": flash, **others}


def check_routes(expect: dict[str, int], what: str) -> dict[str, int]:
    """The sharded routes taken since ``zero_launches``
    (``core.dtensor.route_counts``): exactly ``expect`` of each it names,
    none of the others."""
    from repro_torch.core.dtensor import route_counts
    got = dict(route_counts)
    want = {name: expect.get(name, 0) for name in got}
    check(got == want, f"{what}: sharded routes {got}, want {want}")
    return got


def card() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")
    return smi


def build() -> tuple[float, dict]:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.library_path()
    lib = _build.library()
    secs = time.perf_counter() - t0
    print(f"[build] {path.relative_to(ROOT)} in {secs:.2f} s")
    log = path.with_suffix(".log").read_text().strip()
    print(log)
    # The bf16 flash kernel per head dim: ptxas's registers (at launch; the
    # consumers raise theirs to 240 with setmaxnreg) and spills, and the
    # dynamic shared memory it asks for.
    sm90 = ptxas_report(log, r"flash_attention_sm90_kernelILi(\d+)E",
                        lambda m: int(m[1]))
    for d, row in sorted(sm90.items()):
        row["dynamic_smem_bytes"] = lib.flash_attention_sm90_smem_bytes(d)
        print(f"[build] flash_attention_sm90 D={d}: {row.get('registers')} "
              f"registers at launch, {row.get('spill_bytes')} B spilled, "
              f"{row['dynamic_smem_bytes']:,} B dynamic shared memory")
    check(sorted(sm90) == [16, 32, 64, 80, 96, 128, 256],
          f"flash_attention_sm90 ptxas report: {sm90}")
    # The f32 CUDA-core flash kernel per head dim: registers (at launch; the
    # consumers raise theirs to 232 with setmaxnreg), spills (none allowed
    # at any head dim) and dynamic shared memory; the bf16 kernel may not
    # spill at phi3's D = 96.
    f32 = ptxas_report(log, r"flash_attention_fwd_kernelILi(\d+)E",
                       lambda m: int(m[1]))
    for d, row in sorted(f32.items()):
        row["dynamic_smem_bytes"] = lib.flash_attention_f32_smem_bytes(d)
        print(f"[build] flash_attention (f32) D={d}: {row.get('registers')} "
              f"registers at launch, {row.get('spill_bytes')} B spilled, "
              f"{row['dynamic_smem_bytes']:,} B dynamic shared memory")
    check(sorted(f32) == sorted(sm90)
          and sm90[96].get("spill_bytes") == 0
          and all(row.get("spill_bytes") == 0 for row in f32.values()),
          f"flash spills or is missing: bf16 at D=96 {sm90.get(96)}, f32 "
          f"{f32}")
    # The fused-conv kernel per route and tile width (f32: per patch copy,
    # 16 bytes along Cin or 4 for the stem; bf16: 16-byte copies, the stem
    # padded to 8 channels by the wrapper): registers, spills (none
    # allowed) and dynamic shared memory.
    conv_routes = {}
    for kind, name, instance, keys in (
            ("f32", "fused_conv_sm90", r"ILi(\d+)ELb(\d)E",
             ["BN128_16B", "BN128_4B", "BN64_16B", "BN64_4B"]),
            ("bf16", "fused_conv_bf16_sm90", r"ILi(\d+)EE",
             ["BN128", "BN64"])):
        conv = ptxas_report(
            log, name + "_kernel" + instance,
            lambda m: f"BN{m[1]}" + (f"_{('4', '16')[int(m[2])]}B"
                                     if m.lastindex == 2 else ""))
        for key, row in sorted(conv.items()):
            row["dynamic_smem_bytes"] = lib.fused_conv_sm90_smem_bytes(
                int(key[2:].split("_")[0]), int(kind == "bf16"))
            print(f"[build] {name} {key}: {row.get('registers')} "
                  f"registers, {row.get('spill_bytes')} B spilled, "
                  f"{row['dynamic_smem_bytes']:,} B dynamic shared memory")
        check(sorted(conv) == keys
              and all(row.get("spill_bytes") == 0 for row in conv.values()),
              f"{name} ptxas report: {conv}")
        conv_routes[kind] = conv
    # The SSD scan's three kernels, per chunk (64, 128) where built:
    # registers, spills (none allowed) and dynamic shared memory.
    scan = ptxas_report(log, r"(mamba_scan_(?:chunk_state|state_pass|"
                             r"chunk_output)_kernel)(?:ILi(\d+)E)?",
                        lambda m: m[1] + (f"<{m[2]}>" if m[2] else ""))
    for key, row in sorted(scan.items()):
        phase = 1 if "state_kernel" in key else 3 if "output" in key else 0
        row["dynamic_smem_bytes"] = lib.mamba_scan_sm90_smem_bytes(
            phase, int(key[key.index("<") + 1:-1])) if phase else 0
        print(f"[build] {key}: {row.get('registers')} registers, "
              f"{row.get('spill_bytes')} B spilled, "
              f"{row['dynamic_smem_bytes']:,} B dynamic shared memory")
    check(len(scan) == 5
          and all(row.get("spill_bytes") == 0 for row in scan.values()),
          f"mamba_scan_sm90 ptxas report: {scan}")
    # The mLSTM scan's four kernels.
    mlstm = ptxas_report(log, r"(mlstm_(?:gates_scores|chunk_carry|"
                              r"state_pass|chunk_output)_kernel)"
                              r"(?:ILi(\d+)E)?",
                         lambda m: m[1] + (f"<{m[2]}>" if m[2] else ""))
    phases = {"gates_scores": 1, "chunk_carry": 2, "state_pass": 3,
              "chunk_output": 4}
    for key, row in sorted(mlstm.items()):
        phase = next((n for name, n in phases.items() if name in key), 0)
        row["dynamic_smem_bytes"] = lib.mlstm_scan_sm90_smem_bytes(
            phase, int(key[key.index("<") + 1:-1])) if phase else 0
        print(f"[build] {key}: {row.get('registers')} registers, "
              f"{row.get('spill_bytes')} B spilled, "
              f"{row['dynamic_smem_bytes']:,} B dynamic shared memory")
    check(len(mlstm) == 4
          and all(row.get("spill_bytes") == 0 for row in mlstm.values()),
          f"mlstm_scan_sm90 ptxas report: {mlstm}")
    # The two scans' backward kernels, four and six launches: registers,
    # spills (none allowed) and dynamic shared memory.
    backward = {}
    for lib_name, pattern, phases, count in (
            ("mamba_scan_bwd_sm90", r"(mamba_bwd_(?:chunk|pass|grad|"
             r"group_sum)_kernel)", {"chunk": 1, "grad": 3}, 4),
            ("mlstm_scan_bwd_sm90", r"(mlstm_bwd_(?:gates|scores|rows|pairs|"
             r"products|gate_grads)_kernel)",
             {"scores": 2, "pairs": 4, "products": 5}, 6)):
        report = ptxas_report(log, pattern, lambda m: m[1])
        smem = getattr(lib, f"{lib_name}_smem_bytes")
        for key, row in sorted(report.items()):
            phase = next((n for name, n in phases.items()
                          if f"_bwd_{name}_kernel" in key), 0)
            row["dynamic_smem_bytes"] = smem(phase) if phase else 0
            print(f"[build] {key}: {row.get('registers')} registers, "
                  f"{row.get('spill_bytes')} B spilled, "
                  f"{row['dynamic_smem_bytes']:,} B dynamic shared memory")
        check(len(report) == count
              and all(row.get("spill_bytes") == 0 for row in report.values()),
              f"{lib_name} ptxas report: {report}")
        backward[lib_name] = report
    # The flash backward's kernels, per head dim on each route: bf16
    # (flash_attention_bwd_sm90.cu: the prep launch, the main kernel at
    # every D, the dq conversion built for D <= 128 and for D = 256), f32
    # (flash_attention_bwd.cu: the prep launch and the main kernel at every
    # D): registers, spills (none allowed) and, for the main kernels,
    # dynamic shared memory.
    flash_bwd = ptxas_report(log, r"(flash_bwd_(?:f32_)?(?:(?:sm90|prep|"
                                  r"dq_convert)_)?kernel)(?:ILi(\d+)E)?",
                             lambda m: m[1] + (f"<{m[2]}>" if m[2] else ""))
    for key, row in sorted(flash_bwd.items()):
        d = int(key[key.index("<") + 1:-1]) if "<" in key else 0
        if "_sm90_" in key:
            row["dynamic_smem_bytes"] = (
                lib.flash_attention_bwd_sm90_smem_bytes(d))
        elif "_f32_" in key and d:
            row["dynamic_smem_bytes"] = lib.flash_attention_bwd_f32_smem_bytes(
                d)
        print(f"[build] {key}: {row.get('registers')} registers, "
              f"{row.get('spill_bytes')} B spilled"
              + (f", {row['dynamic_smem_bytes']:,} B dynamic shared memory"
                 if "dynamic_smem_bytes" in row else ""))
    wgmma_dims = sorted(int(k[k.index("<") + 1:-1]) for k in flash_bwd
                        if "_sm90_" in k)
    f32_dims = sorted(int(k[k.index("<") + 1:-1]) for k in flash_bwd
                      if k.startswith("flash_bwd_f32_kernel<"))
    check(len(flash_bwd) == (1 + 2 + 7) + (1 + 7)
          and wgmma_dims == [16, 32, 64, 80, 96, 128, 256]
          and f32_dims == [16, 32, 64, 80, 96, 128, 256]
          and all(row.get("spill_bytes") == 0 for row in flash_bwd.values()),
          f"flash backward ptxas report: {flash_bwd}")
    backward["flash_attention_bwd"] = flash_bwd
    return secs, {"flash_attention_sm90": sm90, "flash_attention_f32": f32,
                  "fused_conv_sm90": conv_routes["f32"],
                  "fused_conv_bf16_sm90": conv_routes["bf16"],
                  "mamba_scan_sm90": scan, "mlstm_scan_sm90": mlstm,
                  **backward}


def ptxas_report(log: str, instance: str, key) -> dict:
    """Registers and spilled bytes of each kernel instance whose mangled
    name matches ``instance`` in ptxas's ``-v`` report, by ``key(match)``."""
    report, n = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(instance, line)
            n = key(m) if m else None
        elif n is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            report.setdefault(n, {})["spill_bytes"] = int(m[1]) + int(m[2])
        elif n is not None and (m := re.search(r"Used (\d+) registers",
                                               line)):
            report.setdefault(n, {})["registers"] = int(m[1])
    return report


def conv_inputs(i: int, shape):
    _, _, hw, cin, cout, k, s, p, _, res = shape
    g = torch.Generator(device="cuda").manual_seed(SEED + 100 + i)

    def randn(*size):
        return torch.randn(size, generator=g, device="cuda")
    x = randn(BATCH, hw, hw, cin)
    w = randn(k, k, cin, cout) * (2.0 / (k * k * cin)) ** 0.5
    scale = 1 + 0.1 * randn(cout)
    shift = 0.1 * randn(cout)
    oh = (hw + 2 * p - k) // s + 1
    residual = randn(BATCH, oh, oh, cout) if res else None
    return x, w, scale, shift, residual


def conv16_inputs(i: int, shape):
    """``conv_inputs`` with x, w and the residual rounded to bf16, the bf16
    route's operands; scale and shift stay f32, as a folded BN is."""
    x, w, scale, shift, res = conv_inputs(i, shape)
    return (x.bfloat16(), w.bfloat16(), scale, shift,
            None if res is None else res.bfloat16())


def conv_plan(shape, kind: str = "f32") -> tuple[int, int]:
    """The tile width and split of K the wrapper picks for ``shape`` on the
    ``kind`` route."""
    from repro_torch.kernels.fused_conv import (K_BLOCKS, padded_cin, plan,
                                                resident_blocks)
    _, _, hw, cin, cout, k, s, p, _, _ = shape
    oh = (hw + 2 * p - k) // s + 1
    if kind == "bf16":
        cin = padded_cin(cin)
    return plan(BATCH * oh * oh, cout, k * k * cin,
                resident_blocks(torch.cuda.current_device(), kind),
                K_BLOCKS[kind])


def kernel_check() -> list[dict]:
    from repro_torch.kernels.fused_conv import fused_conv_kernel
    from repro_torch.kernels.ref import fused_conv_ref
    rows = []
    for i, shape in enumerate(CONV_SHAPES):
        name, count, _, _, _, _, s, p, relu, _ = shape
        x, w, scale, shift, res = conv_inputs(i, shape)
        kw = dict(stride=s, padding=p, relu=relu, residual=res)
        out = fused_conv_kernel(x, w, scale, shift, **kw)
        again = fused_conv_kernel(x, w, scale, shift, **kw)
        torch.cuda.synchronize()
        ref = fused_conv_ref(x, w, scale, shift, **kw)
        check(out.shape == ref.shape, f"{name}: shape {out.shape} vs "
              f"{ref.shape}")
        err, rel = rel_err(out, ref)
        tile_n, splits = conv_plan(shape)
        print(f"[check] {name:16s} out {tuple(out.shape)} tile 128x{tile_n} "
              f"split {splits} max_abs_err {err:.3e} rel {rel:.3e}")
        check(rel <= KERNEL_RTOL, f"{name}: kernel vs plain rel err {rel:.3e}"
              f" > {KERNEL_RTOL}")
        check(torch.equal(out, again), f"{name}: two launches differ")
        rows.append({"name": name, "per_forward": count,
                     "out": list(out.shape), "tile_n": tile_n,
                     "splits": splits, "max_abs_err": err, "rel_err": rel})
    return rows


def within_bf16(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """The largest |out − ref| and the largest share of the bf16 limit
    BF16_ULP·|ref| + KERNEL_RTOL·max|ref| an element uses."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    limit = BF16_ULP * r.abs() + KERNEL_RTOL * r.abs().max()
    return err.max().item(), (err / limit).max().item()


def kernel_check_bf16() -> list[dict]:
    """Phase 3's shapes on the bf16 route: every element within the bf16
    limit of the plain version on the same operands, two launches
    bit-equal, every launch on the bf16 route."""
    from repro_torch.kernels.fused_conv import fused_conv_kernel
    from repro_torch.kernels.ref import fused_conv_ref
    rows = []
    zero_launches()
    for i, shape in enumerate(CONV_SHAPES):
        name, count, _, _, _, _, s, p, relu, _ = shape
        x, w, scale, shift, res = conv16_inputs(i, shape)
        kw = dict(stride=s, padding=p, relu=relu, residual=res)
        out = fused_conv_kernel(x, w, scale, shift, **kw)
        again = fused_conv_kernel(x, w, scale, shift, **kw)
        torch.cuda.synchronize()
        ref = fused_conv_ref(x, w, scale, shift, **kw)
        check(out.shape == ref.shape and out.dtype == torch.bfloat16,
              f"{name} bf16: {out.shape} {out.dtype} vs {ref.shape}")
        err, used = within_bf16(out, ref)
        tile_n, splits = conv_plan(shape, "bf16")
        print(f"[check] bf16 {name:16s} out {tuple(out.shape)} tile "
              f"128x{tile_n} split {splits} max_abs_err {err:.3e} (max "
              f"|plain| {ref.abs().max().item():.3f}) limit used {used:.3f}")
        check(used <= 1, f"{name} bf16: kernel vs plain uses {used:.3f} of "
              f"the limit")
        check(torch.equal(out, again), f"{name} bf16: two launches differ")
        rows.append({"name": name, "per_forward": count,
                     "out": list(out.shape), "tile_n": tile_n,
                     "splits": splits, "max_abs_err": err,
                     "limit_used": used})
    check_launches({"fused_conv": 2 * len(CONV_SHAPES)}, "bf16 conv check",
                   conv_route="bf16")
    return rows


def perturb_bn(tree: dict, g: torch.Generator) -> None:
    """Moves every BN off the identity, so that folding it matters."""
    for v in tree.values():
        if isinstance(v, dict) and "var" in v:
            c = v["var"].shape[0]
            v["mean"].copy_(0.1 * torch.randn(c, generator=g))
            v["var"].copy_(0.5 + torch.rand(c, generator=g))
            v["scale"].copy_(1 + 0.1 * torch.randn(c, generator=g))
            v["bias"].copy_(0.1 * torch.randn(c, generator=g))
        elif isinstance(v, dict):
            perturb_bn(v, g)


def resnet_requests() -> list[torch.Tensor]:
    """The REQUESTS batches of images ResNet18 serves, from a seed."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    return [torch.randn(BATCH, IMAGE_HW, IMAGE_HW, 3, generator=g,
                        device="cuda") for _ in range(REQUESTS)]


def model_path() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_conv as fc
    from repro_torch.models import build_model
    from repro_torch.models import resnet as R
    cfg = get_config("resnet18")
    model = build_model(cfg)
    check(model.device.type == "cuda", f"built on {model.device}")
    params = R.init_resnet18(torch.Generator().manual_seed(SEED),
                             cfg.vocab_size, device=model.device)
    perturb_bn(params, torch.Generator().manual_seed(SEED + 1))
    net = R.ResNet18(cfg.vocab_size, params=params, device=model.device)
    requests = resnet_requests()

    zero_launches()
    logits, latency_ms = [], []
    for x in requests:
        before = fc.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = model.forward(net, {"images": x})
        torch.cuda.synchronize()
        latency_ms.append((time.perf_counter() - t0) * 1e3)
        check(fc.launches - before == CONVS_PER_FORWARD,
              f"{fc.launches - before} fused-conv launches in a forward")
        logits.append(out)
    before = fc.launches
    fused = net.forward_fused_groups(requests[0])
    torch.cuda.synchronize()
    check(fc.launches - before == CONVS_PER_FORWARD,
          f"{fc.launches - before} launches in forward_fused_groups")
    launches = check_launches({"fused_conv": fc.launches},
                              "ResNet18 requests")["fused_conv"]
    print(f"[model] {REQUESTS} requests of {BATCH}x{IMAGE_HW}x{IMAGE_HW}x3, "
          f"{cfg.vocab_size} classes: latency ms "
          f"{[round(t, 3) for t in latency_ms]}, fused_conv launches "
          f"{launches} ({CONVS_PER_FORWARD} per forward)")

    for out in logits:
        check(tuple(out.shape) == (BATCH, cfg.vocab_size),
              f"logits shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite logits")
    _, fused_rel = rel_err(fused, logits[0])
    check(fused_rel <= FUSED_RTOL,
          f"forward_fused_groups vs forward rel err {fused_rel:.3e}")
    cpu_params = R.fold_bn(_to_cpu(net.params))
    t0 = time.perf_counter()
    ref = R.forward(cpu_params, requests[0].cpu())
    ref_s = time.perf_counter() - t0
    err, rel = rel_err(logits[0].cpu(), ref)
    print(f"[model] fused groups vs forward rel err {fused_rel:.3e}; kernel "
          f"path vs plain CPU forward ({ref_s:.1f} s) max_abs_err {err:.3e} "
          f"rel {rel:.3e}; logits max |.| {ref.abs().max().item():.3e}")
    check(rel <= LOGITS_RTOL, f"logits vs plain rel err {rel:.3e} > "
          f"{LOGITS_RTOL}")
    return {"net": net, "x": requests[0], "launches": launches,
            "request_latency_ms": latency_ms, "logits_max_abs_err": err,
            "logits_rel_err": rel, "fused_groups_rel_err": fused_rel}


def _to_cpu(tree: dict) -> dict:
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def bf16_tree(tree: dict) -> dict:
    """``tree`` as JAX's bf16 ResNet18 keeps it (``init_resnet18(key, n,
    jnp.bfloat16)``): every leaf bf16 but the BN statistics, f32."""
    return {k: bf16_tree(v) if isinstance(v, dict)
            else v if k in ("mean", "var") else v.bfloat16()
            for k, v in tree.items()}


def f32_tree(tree: dict) -> dict:
    return {k: f32_tree(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def bf16_distances(out: torch.Tensor, plain: torch.Tensor,
                   ref32: torch.Tensor, what: str) -> dict:
    """BF16_DIST_FACTOR's rule: ``out`` (a bf16 kernel path) no farther
    from ``ref32`` (the f32 kernel path of the same weights and input) than
    BF16_DIST_FACTOR times ``plain`` (the bf16 path under ops.plain())."""
    d_kernel = (out.float() - ref32).abs().max().item()
    d_plain = (plain.float() - ref32).abs().max().item()
    check(d_kernel <= BF16_DIST_FACTOR * d_plain,
          f"{what}: bf16 kernel path {d_kernel:.3e} from the f32 kernel "
          f"path, more than {BF16_DIST_FACTOR} x the plain bf16 path's "
          f"{d_plain:.3e}")
    return {"d_kernel": d_kernel, "d_plain": d_plain,
            "max_abs_f32": ref32.abs().max().item()}


def model_path_bf16(params: dict) -> dict:
    """ResNet18 in bf16 (the resnet18 config with both dtypes bf16, as in
    JAX) built through ``build_model`` on phase 4's weights (``params``) as
    JAX's bf16 tree keeps them, serving phase 4's requests in bf16, then
    ``forward_fused_groups``: 20 launches a forward, all on the bf16 route,
    finite logits, the fused groups bit-equal to the forward; the first
    request held by BF16_DIST_FACTOR's rule against the f32 kernel forward
    of the same weights (its 20 launches on the f32 route) beside the plain
    bf16 forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_conv as fc
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models import resnet as R
    cfg = dataclasses.replace(get_config("resnet18"), dtype="bfloat16",
                              param_dtype="bfloat16")
    model = build_model(cfg)
    tree = bf16_tree(params)
    net = R.ResNet18(cfg.vocab_size, params=tree, device=model.device)
    twin = R.ResNet18(cfg.vocab_size, params=f32_tree(tree),
                      device=model.device)
    requests = [x.bfloat16() for x in resnet_requests()]

    zero_launches()
    logits, latency_ms = [], []
    for x in requests:
        before = fc.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = model.forward(net, {"images": x})
        torch.cuda.synchronize()
        latency_ms.append((time.perf_counter() - t0) * 1e3)
        check(fc.launches - before == CONVS_PER_FORWARD,
              f"{fc.launches - before} fused-conv launches in a bf16 forward")
        logits.append(out)
    before = fc.launches
    fused = net.forward_fused_groups(requests[0])
    torch.cuda.synchronize()
    check(fc.launches - before == CONVS_PER_FORWARD,
          f"{fc.launches - before} launches in the bf16 forward_fused_groups")
    launches = check_launches({"fused_conv": fc.launches},
                              "bf16 ResNet18 requests",
                              conv_route="bf16")["fused_conv"]
    for out in logits:
        check(tuple(out.shape) == (BATCH, cfg.vocab_size)
              and out.dtype == torch.bfloat16,
              f"bf16 logits {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), "non-finite bf16 logits")
    check(torch.equal(fused, logits[0]),
          "bf16 forward_fused_groups differs from the forward")

    zero_launches()
    ref32 = twin(requests[0].float())
    torch.cuda.synchronize()
    check_launches({"fused_conv": CONVS_PER_FORWARD}, "the f32 twin forward")
    before = launch_counts()
    with ops.plain():
        plain = net(requests[0])
    torch.cuda.synchronize()
    check(launch_counts() == before, "ops.plain() launched a kernel")
    held = bf16_distances(logits[0], plain, ref32, "bf16 ResNet18 logits")
    top2 = ref32.topk(2, dim=-1).values
    sure = top2[:, 0] - top2[:, 1] > held["d_kernel"] + held["d_plain"]
    agree = logits[0].float().argmax(-1) == plain.float().argmax(-1)
    check(bool(agree[sure].all()), f"bf16 ResNet18: top-1 differs from the "
          f"plain bf16 forward where the f32 margin exceeds both distances "
          f"({agree.tolist()}, {sure.tolist()})")
    print(f"[model] bf16: {REQUESTS} requests of {BATCH}x{IMAGE_HW}x"
          f"{IMAGE_HW}x3: latency ms {[round(t, 3) for t in latency_ms]}, "
          f"fused_conv launches {launches} ({CONVS_PER_FORWARD} per forward, "
          f"all bf16 route); fused groups == forward; logits vs the f32 "
          f"kernel forward of the same weights: kernel {held['d_kernel']:.3e}"
          f", plain bf16 {held['d_plain']:.3e} (limit {BF16_DIST_FACTOR} x; "
          f"max |f32 logits| {held['max_abs_f32']:.3e}); top-1 equal to "
          f"plain on {int(sure.sum())} of {BATCH} rows held by the margin "
          f"({int(agree.sum())} of {BATCH} equal)")
    return {"net": net, "twin": twin, "x": requests[0], "launches": launches,
            "request_latency_ms": latency_ms, **held,
            "top1_held_rows": int(sure.sum()),
            "top1_equal_rows": int(agree.sum())}


def touched(n: int, k: int, s: int, p: int) -> int:
    """How many of n input rows (or columns) a k-wide window at stride s and
    padding p reads: a 1x1/s2 conv reads every other one."""
    o = (n + 2 * p - k) // s + 1
    return len({i * s - p + r for i in range(o) for r in range(k)}
               & set(range(n)))


def roofline(ops_: int, nbytes: int, peak: float = PEAK_F32_OPS,
             **extra) -> dict:
    """The least time the card could take: the larger of the operations
    over ``peak`` and the bytes over the memory rate."""
    ops_ms, bytes_ms = ops_ / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"ops": ops_, "bytes": nbytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            **extra}


def bounds(shape) -> dict:
    """The kernel's bound (its three bf16 products, 3·2·M·N·K operations at
    the tensor cores' rate) and, as ``bound_f32_ms``, the bound of the same
    f32 work on the CUDA cores; ``ops`` is the f32 work, for TFLOP/s."""
    _, _, hw, cin, cout, k, s, p, relu, res = shape
    oh = (hw + 2 * p - k) // s + 1
    m, kk = BATCH * oh * oh, k * k * cin
    ops = 2 * m * cout * kk + m * cout * (2 + int(res) + int(relu))
    nbytes = 4 * (BATCH * touched(hw, k, s, p) ** 2 * cin + kk * cout
                  + 2 * cout + m * cout * (1 + int(res)))
    f32 = roofline(ops, nbytes)
    return {**roofline(3 * 2 * m * cout * kk, nbytes, peak=PEAK_BF16_OPS),
            "ops": ops, "bound_f32_ms": f32["bound_ms"],
            "bound_f32_by": f32["bound_by"]}


def bounds_bf16(shape) -> dict:
    """The bf16 route's bound: one bf16 product, 2·M·N·K operations at the
    tensor cores' rate, a third of the f32 route's, or its bytes (bf16 x as
    the window reads it, w, the residual and the output; f32 scale and
    shift), half the f32 route's; ``ops`` is the conv and its epilogue, for
    TFLOP/s."""
    _, _, hw, cin, cout, k, s, p, relu, res = shape
    oh = (hw + 2 * p - k) // s + 1
    m, kk = BATCH * oh * oh, k * k * cin
    ops = 2 * m * cout * kk + m * cout * (2 + int(res) + int(relu))
    nbytes = 2 * (BATCH * touched(hw, k, s, p) ** 2 * cin + kk * cout
                  + m * cout * (1 + int(res))) + 4 * 2 * cout
    return {**roofline(2 * m * cout * kk, nbytes, peak=PEAK_BF16_OPS),
            "ops": ops}


def shape_timings(rows: list[dict], inputs, bounds_fn, tag: str) -> None:
    """Per conv shape of ``rows`` (one route's, operands from ``inputs``):
    the kernel, its plain version and the library conv (``F.conv2d``
    channels-last in the operands' dtype, without the epilogue) by CUDA
    events, the kernel's and the library's device time, the bound from
    ``bounds_fn`` and TFLOP/s."""
    from repro_torch.kernels.fused_conv import fused_conv_kernel
    from repro_torch.kernels.ref import fused_conv_ref
    for i, (shape, row) in enumerate(zip(CONV_SHAPES, rows)):
        _, _, _, _, _, _, s, p, relu, _ = shape
        x, w, scale, shift, res = inputs(i, shape)
        kw = dict(stride=s, padding=p, relu=relu, residual=res)
        x_nchw = x.permute(0, 3, 1, 2)          # channels-last view, no copy
        w_lib = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        row.update(bounds_fn(shape))
        row["ms"] = cuda_ms(lambda: fused_conv_kernel(x, w, scale, shift,
                                                      **kw))
        row["plain_ms"] = cuda_ms(lambda: fused_conv_ref(x, w, scale, shift,
                                                         **kw))
        row["library_ms"] = cuda_ms(lambda: F.conv2d(x_nchw, w_lib, stride=s,
                                                     padding=p))
        # The calls above are timed back to back from Python, so a short
        # kernel's time is its caller's host time; this is the card's own.
        row["device_ms"] = device_ms(lambda: fused_conv_kernel(
            x, w, scale, shift, **kw))
        row["library_device_ms"] = device_ms(lambda: F.conv2d(
            x_nchw, w_lib, stride=s, padding=p))
        print(f"[time] {tag}{row['name']:16s} x{row['per_forward']} 128x"
              f"{row['tile_n']}/{row['splits']} kernel {row['ms']:.4f} ms  "
              f"plain {row['plain_ms']:.4f}  library {row['library_ms']:.4f}"
              f"  bound {row['bound_ms']:.4f} ({row['bound_by']}; "
              f"operations {row['ops_ms']:.4f}, bytes {row['bytes_ms']:.4f})"
              + (f" f32 on the CUDA cores {row['bound_f32_ms']:.4f} "
                 f"({row['bound_f32_by']})" if "bound_f32_ms" in row else "")
              + f"  {row['ops'] / row['ms'] / 1e9:.1f} TFLOP/s; on the card "
              f"kernel {fmt_ms(row['device_ms'])} library "
              f"{fmt_ms(row['library_device_ms'])}")


def timings(rows: list[dict], model: dict) -> dict:
    shape_timings(rows, conv_inputs, bounds, "")
    net, x = model["net"], model["x"]
    fwd_ms = cuda_ms(lambda: net(x), iters=10)
    print(f"[time] forward batch {BATCH} at {IMAGE_HW}²: {fwd_ms:.3f} ms "
          f"(CUDA events, mean of 10)")
    return {"forward_ms": fwd_ms}


def timings_bf16(rows: list[dict], model: dict) -> dict:
    """Phase 5 for the bf16 route: per shape as ``timings``, with cuDNN's
    bf16 conv as the library, and the bf16 forward by CUDA events and by
    the device time of its kernels."""
    shape_timings(rows, conv16_inputs, bounds_bf16, "bf16 ")
    net, x = model["net"], model["x"]
    fwd_ms = cuda_ms(lambda: net(x), iters=10)
    fwd_dev = device_ms(lambda: net(x), runs=5)
    print(f"[time] bf16 forward batch {BATCH} at {IMAGE_HW}²: {fwd_ms:.3f} "
          f"ms (CUDA events, mean of 10), on the card {fmt_ms(fwd_dev)} ms")
    return {"forward_ms": fwd_ms, "forward_device_ms": fwd_dev}


def device_ms(fn, runs: int = 10) -> float | None:
    """The device time of the kernels one ``fn()`` launches, the mean over
    ``runs`` calls, from torch.profiler's CUDA trace; None when the
    profiler recorded no device time."""
    by_name = device_ms_by_kernel(fn, runs)
    return None if by_name is None else sum(by_name.values())


def device_ms_by_kernel(fn, runs: int = 10) -> dict[str, float] | None:
    """``device_ms`` per device kernel name."""
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = e.time_range
            by_name[e.name] = by_name.get(e.name, 0.0) + (t.end - t.start)
    if not by_name:
        return None
    return {name: us / runs / 1e3 for name, us in by_name.items()}


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def device_breakdown(events, window_name: str, runs: int) -> dict | None:
    """Device time by kernel name and the device's idle share inside the
    host annotation ``window_name``, from torch.profiler's CUDA trace;
    None when the profiler recorded no device time."""
    window = next(e for e in events if e.name == window_name).time_range
    spans = sorted((max(e.time_range.start, window.start),
                    min(e.time_range.end, window.end), e.name)
                   for e in events   # annotations also show on the device
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name != window_name
                   and e.name not in ANNOTATIONS)
    if not spans:
        return None
    busy, reach, by_name = 0.0, window.start, {}
    for start, end, name in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + end - start)
    wall = window.end - window.start
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    result = {"runs": runs, "window_us": wall, "device_busy_us": busy,
              "idle_share": 1 - busy / wall,
              "kernels": [{"name": k[:80], "count": n, "us": t}
                          for k, (n, t) in ranked[:8]],
              "all_kernels": [{"name": k, "count": n, "us": t}
                              for k, (n, t) in ranked]}
    print(f"[profile] {window_name} x{runs}: window {wall:.0f} us, device "
          f"busy {busy:.0f} us, idle share {result['idle_share']:.3f}")
    for k in result["kernels"]:
        print(f"[profile]   {k['us'] / runs:9.1f} us/run "
              f"x{k['count'] // runs:<3d} {k['name']}")
    return result


def profile(model: dict) -> dict:
    """Device time by kernel name and the device's idle share over a window
    of back-to-back forwards, from torch.profiler's CUDA trace."""
    from torch.profiler import ProfilerActivity, record_function
    net, x = model["net"], model["x"]
    net(x)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with record_function("forwards"):
            for _ in range(PROFILE_FORWARDS):
                net(x)
            torch.cuda.synchronize()
    result = device_breakdown(prof.events(), "forwards", PROFILE_FORWARDS)
    if result is None:
        print("[profile] the profiler recorded no device time: not measured")
    else:
        del result["all_kernels"]
    return {"profile": result}


def halo_path(model: dict, smi: str) -> dict:
    """The paper's halo dataflow on the card: ResNet18's fused groups row-
    sharded with one halo exchange each, the exact per-layer form, and the
    windowed K/V halo of gemma2-2b's local attention.  Each sharded conv
    path is held at every row against the same sharded call under
    ``ops.plain()`` and, where the halo pattern allows, against its
    unsharded self; the attention against its unsharded self.  Then
    CUDA-event times of both."""
    from repro_torch.configs import get_config
    from repro_torch.core import halo as H
    from repro_torch.kernels import ops
    from repro_torch.core.seq_halo import (halo_vs_gather_bytes,
                                           windowed_attention_halo)
    from repro_torch.core.tiling import resnet18_fused_groups
    from repro_torch.models import layers as L
    from repro_torch.models import resnet as R
    p = model["net"].folded
    fns, _ = R.fused_group_fns(p)
    x = model["x"]
    rows = []
    for gi, (fn, group, n, launches) in enumerate(zip(
            fns, resnet18_fused_groups(IMAGE_HW), HALO_SHARDS,
            HALO_LAUNCHES)):
        stride = group[0].iy // group[-1].oy
        halo = stride * math.ceil(H.group_halo_rows(group, n) / stride)
        shrink = halo // stride
        whole = fn(x)
        zero_launches()
        out = H.run_fused_group(fn, x, n, halo=halo, shrink=shrink)
        torch.cuda.synchronize()
        check_launches({"fused_conv": launches}, f"halo group {gi}")
        check(out.shape == whole.shape, f"halo group {gi}: {out.shape}")
        before = launch_counts()
        with ops.plain():
            ref = H.run_fused_group(fn, x, n, halo=halo, shrink=shrink)
        torch.cuda.synchronize()
        check(launch_counts() == before, "ops.plain() launched a kernel")
        err, rel = rel_err(out, ref)
        limit = HALO_RTOL * whole.abs().max().item()
        dev = (out - whole).abs().amax(dim=(0, 2, 3))
        per = whole.shape[1] // n
        bad = [r for r in range(whole.shape[1]) if dev[r].item() > limit]
        # two shards have no interior one: then the rows are only printed
        interior = dev[per:-per].max().item() if n > 2 else None
        print(f"[halo] group {gi} ({group[0].name}..{group[-1].name}) "
              f"{tuple(x.shape)} -> {tuple(out.shape)}: {n} shards, halo "
              f"{halo}, shrink {shrink}, {launches} fused_conv launches; "
              f"vs plain sharded max err {err:.3e} at any row (rel "
              f"{rel:.3e}, limit {HALO_RTOL}); vs whole: interior shards "
              + (f"max err {interior:.3e} (limit {limit:.3e})"
                 if interior is not None else "none")
              + f", {len(bad)} of {whole.shape[1]} rows deviate (rows {bad}), "
              f"up to {dev.max().item():.3e}")
        check(rel <= HALO_RTOL, f"halo group {gi}: kernel vs plain sharded "
              f"rel err {rel:.3e} > {HALO_RTOL}")
        if interior is not None:
            check(interior <= limit, f"halo group {gi}: interior rows err "
                  f"{interior:.3e} > {limit:.3e}")
            check(all(r < per or r >= whole.shape[1] - per for r in bad),
                  f"halo group {gi}: rows {bad} deviate outside the boundary "
                  f"shards")
        del ref
        rows.append({"group": gi, "shards": n, "halo": halo,
                     "shrink": shrink, "launches": launches,
                     "max_abs_err": err, "rel_err": rel,
                     "interior_max_abs_err": interior, "limit": limit,
                     "rows_deviating": bad,
                     "max_deviation": dev.max().item(),
                     "ms": cuda_ms(lambda: H.run_fused_group(
                         fn, x, n, halo=halo, shrink=shrink), HALO_ITERS),
                     "whole_ms": cuda_ms(lambda: fn(x), HALO_ITERS)})
        x = whole                     # the next group's input

    x = R.stem(p, model["x"])
    layers = [(lambda w, bn: (lambda t: R.conv_bn(w, bn, t, 1, 1, True)))(
        p[blk][f"conv{c}"], p[blk][f"bn{c}"])
        for blk in ("s1b1", "s1b2") for c in (1, 2)]

    def chain(t):
        for fn in layers:
            t = fn(t)
        return t
    whole = chain(x)
    zero_launches()
    out = H.run_fused_group_exact(layers, x, EXACT_SHARDS, halo=EXACT_HALO)
    torch.cuda.synchronize()
    check_launches({"fused_conv": EXACT_LAUNCHES}, "halo exact chain")
    before = launch_counts()
    with ops.plain():
        ref = H.run_fused_group_exact(layers, x, EXACT_SHARDS,
                                      halo=EXACT_HALO)
    torch.cuda.synchronize()
    check(launch_counts() == before, "ops.plain() launched a kernel")
    plain_err, plain_rel = rel_err(out, ref)
    del ref
    limit = HALO_RTOL * whole.abs().max().item()
    err = (out - whole).abs().max().item()
    print(f"[halo] exact chain (stage 1's four 3x3 convs) {tuple(x.shape)}: "
          f"{EXACT_SHARDS} shards, halo {EXACT_HALO}, {EXACT_LAUNCHES} "
          f"fused_conv launches; at any row: vs plain sharded max err "
          f"{plain_err:.3e} (rel {plain_rel:.3e}, limit {HALO_RTOL}), vs "
          f"whole max err {err:.3e} (limit {limit:.3e})")
    check(plain_rel <= HALO_RTOL, f"halo exact chain: kernel vs plain "
          f"sharded rel err {plain_rel:.3e} > {HALO_RTOL}")
    check(err <= limit, f"halo exact chain err {err:.3e} > {limit:.3e}")
    exact = {"shards": EXACT_SHARDS, "halo": EXACT_HALO,
             "launches": EXACT_LAUNCHES, "plain_max_abs_err": plain_err,
             "plain_rel_err": plain_rel, "max_abs_err": err, "limit": limit,
             "ms": cuda_ms(lambda: H.run_fused_group_exact(
                 layers, x, EXACT_SHARDS, halo=EXACT_HALO), HALO_ITERS),
             "whole_ms": cuda_ms(lambda: chain(x), HALO_ITERS)}

    cfg = get_config(LM_CONFIG)
    window, softcap = cfg.sliding_window, cfg.attn_softcap
    g = torch.Generator(device="cuda").manual_seed(SEED + 400)
    q, k, v = (torch.randn(1, SEQ_HALO_S, h, cfg.resolved_head_dim,
                           generator=g, device="cuda")
               for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    mask = L.causal_mask(SEQ_HALO_S, SEQ_HALO_S, window=window).cuda()
    whole = L.attention_scores(q, k, v, mask, softcap)
    zero_launches()
    out = windowed_attention_halo(q, k, v, window=window,
                                  n_shards=SEQ_HALO_SHARDS, softcap=softcap)
    torch.cuda.synchronize()
    check_launches({}, "windowed halo attention")
    err = (out - whole).abs().max().item()
    moved = halo_vs_gather_bytes(SEQ_HALO_S, cfg.num_kv_heads,
                                 cfg.resolved_head_dim, window=window,
                                 n_shards=SEQ_HALO_SHARDS, dtype_bytes=4)
    print(f"[halo] windowed attention {tuple(q.shape)} k/v "
          f"{tuple(k.shape)} f32, window {window}, softcap {softcap}, "
          f"{SEQ_HALO_SHARDS} shards: max err {err:.3e} (limit {FLASH_ATOL})"
          f"; K/V bytes per shard: gather {moved['all_gather']:,.0f}, halo "
          f"{moved['halo']:,.0f} ({moved['ratio']:.2f}x less)")
    check(err <= FLASH_ATOL, f"windowed halo attention err {err:.3e} > "
          f"{FLASH_ATOL}")
    attn = {"shape": list(q.shape), "window": window, "softcap": softcap,
            "shards": SEQ_HALO_SHARDS, "max_abs_err": err,
            "bytes": moved,
            "ms": cuda_ms(lambda: windowed_attention_halo(
                q, k, v, window=window, n_shards=SEQ_HALO_SHARDS,
                softcap=softcap), HALO_ITERS, warmup=1),
            "whole_ms": cuda_ms(lambda: L.attention_scores(
                q, k, v, mask, softcap), HALO_ITERS, warmup=1)}
    del q, k, v, mask, whole, out
    torch.cuda.empty_cache()
    print(f"[time] halo, CUDA events, mean of {HALO_ITERS} after warm-up, "
          f"{smi}: " + "; ".join(
              f"group {r['group']} sharded {r['ms']:.3f} ms, whole "
              f"{r['whole_ms']:.3f}" for r in rows)
          + f"; exact chain sharded {exact['ms']:.3f}, whole "
          f"{exact['whole_ms']:.3f}; windowed attention sharded "
          f"{attn['ms']:.3f}, whole {attn['whole_ms']:.3f}")
    return {"groups": rows, "exact_chain": exact, "windowed_attention": attn}


def halo_groups_bf16(model: dict, smi: str) -> list[dict]:
    """Phase 6's three fused groups in bf16, on phase 4's bf16 net and first
    request: each sharded call makes exactly its launches, all on the bf16
    route, and is held by BF16_DIST_FACTOR's rule at any row against the
    same sharded call of the f32 twin (the f32 route, on the bf16 input
    upcast) beside the bf16 call under ``ops.plain()``; against the group
    run whole, with more than two shards, rows outside the first and last
    shard within BF16_DIST_FACTOR times the plain call's distance (the
    sharded and whole runs differ in their splits of K, which move bf16
    roundings as the plain version's sums do), deviating rows only in
    those two shards."""
    from repro_torch.core import halo as H
    from repro_torch.core.tiling import resnet18_fused_groups
    from repro_torch.kernels import ops
    from repro_torch.models import resnet as R
    fns, _ = R.fused_group_fns(model["net"].folded)
    fns32, _ = R.fused_group_fns(model["twin"].folded)
    x = model["x"]
    rows = []
    for gi, (fn, fn32, group, n, launches) in enumerate(zip(
            fns, fns32, resnet18_fused_groups(IMAGE_HW), HALO_SHARDS,
            HALO_LAUNCHES)):
        stride = group[0].iy // group[-1].oy
        halo = stride * math.ceil(H.group_halo_rows(group, n) / stride)
        shrink = halo // stride

        def sharded(f, t):
            return H.run_fused_group(f, t, n, halo=halo, shrink=shrink)
        whole = fn(x)
        ref32 = sharded(fn32, x.float())
        with ops.plain():
            plain = sharded(fn, x)
        zero_launches()
        out = sharded(fn, x)
        torch.cuda.synchronize()
        check_launches({"fused_conv": launches}, f"bf16 halo group {gi}",
                       conv_route="bf16")
        check(out.shape == whole.shape and out.dtype == torch.bfloat16,
              f"bf16 halo group {gi}: {out.shape} {out.dtype}")
        held = bf16_distances(out, plain, ref32, f"bf16 halo group {gi}")
        limit = BF16_DIST_FACTOR * held["d_plain"]
        dev = (out.float() - whole.float()).abs().amax(dim=(0, 2, 3))
        per = whole.shape[1] // n
        bad = [r for r in range(whole.shape[1]) if dev[r].item() > limit]
        interior = dev[per:-per].max().item() if n > 2 else None
        print(f"[halo] bf16 group {gi} {tuple(x.shape)} -> "
              f"{tuple(out.shape)}: {n} shards, halo {halo}, {launches} "
              f"fused_conv launches (bf16 route); from the f32 twin's "
              f"sharded call at any row: kernel {held['d_kernel']:.3e}, "
              f"plain bf16 {held['d_plain']:.3e} (limit {BF16_DIST_FACTOR} x)"
              f"; vs whole: interior shards "
              + (f"max err {interior:.3e} (limit {limit:.3e})"
                 if interior is not None else "none")
              + f", {len(bad)} of {whole.shape[1]} rows deviate (rows {bad})")
        if interior is not None:
            check(interior <= limit, f"bf16 halo group {gi}: interior rows "
                  f"err {interior:.3e} > {limit:.3e}")
            check(all(r < per or r >= whole.shape[1] - per for r in bad),
                  f"bf16 halo group {gi}: rows {bad} deviate outside the "
                  f"boundary shards")
        del ref32, plain
        rows.append({"group": gi, "shards": n, "halo": halo,
                     "launches": launches, **held, "limit": limit,
                     "interior_max_abs_err": interior, "rows_deviating": bad,
                     "ms": cuda_ms(lambda: sharded(fn, x), HALO_ITERS),
                     "whole_ms": cuda_ms(lambda: fn(x), HALO_ITERS)})
        x = whole                     # the next group's input
    print(f"[time] bf16 halo, CUDA events, mean of {HALO_ITERS} after "
          f"warm-up, {smi}: " + "; ".join(
              f"group {r['group']} sharded {r['ms']:.3f} ms, whole "
              f"{r['whole_ms']:.3f}" for r in rows))
    return rows


# --- gemma2-2b serving: the flash-attention kernel and the LM path ---------------

def key_len(shape) -> int:
    """T of a flash shape: its optional eighth entry, else S."""
    return shape[7] if len(shape) > 7 else shape[3]


def flash_inputs(seed: int, shape, cfg):
    _, _, b, s, _, _, dtype = shape[:7]
    g = torch.Generator(device="cuda").manual_seed(seed)
    hd = cfg.resolved_head_dim

    def randn(heads, length):
        return torch.randn(b * heads, length, hd, generator=g,
                           device="cuda").to(dtype)
    t = key_len(shape)
    return randn(cfg.num_heads, s), randn(cfg.num_kv_heads, t), \
        randn(cfg.num_kv_heads, t)


def flash_kw(shape, cfg) -> dict:
    _, _, _, _, causal, window, _ = shape[:7]
    return dict(causal=causal, window=window, softcap=cfg.attn_softcap)


def flash_held(name: str, q, k, v, kw: dict) -> dict:
    """One launch of the flash kernel of q's dtype, held element by element
    against the plain version in f32, and only that kernel's route moved."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ref import attention_ref
    route = "wgmma_bf16" if q.dtype == torch.bfloat16 else "simt_f32"
    before = dict(FA.launches_by_kernel)
    out = FA.flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    moved = {r: n - before[r] for r, n in FA.launches_by_kernel.items()}
    check(moved == {r: int(r == route) for r in moved},
          f"{name}: flash launches by route moved {moved}, want one {route}")
    ref = attention_ref(q.float(), k.float(), v.float(), **kw)
    check(out.shape == ref.shape and out.dtype == q.dtype,
          f"{name}: {out.shape} {out.dtype} vs {ref.shape}")
    err, rel = rel_err(out, ref)
    used = ((out.float() - ref).abs()
            / (FLASH_RTOL[q.dtype] * ref.abs() + FLASH_ATOL)).max().item()
    print(f"[flash] {name:27s} q {tuple(q.shape)} k {tuple(k.shape)} "
          f"{route}: max_abs_err {err:.3e} rel {rel:.3e} limit used "
          f"{used:.3f}")
    check(used <= 1.0, f"{name}: kernel vs plain exceeds its limit "
          f"{used:.3f}-fold (max abs err {err:.3e})")
    return {"name": name, "route": route,
            "dtype": str(q.dtype).removeprefix("torch."), "max_abs_err": err,
            "rel_err": rel, "limit_used": used}


def flash_check(cfg, shapes, seed: int) -> list[dict]:
    rows = []
    print(f"[flash] limits, per element against the plain version in f32: "
          f"|kernel - plain| <= rtol*|plain| + {FLASH_ATOL}, rtol "
          f"{FLASH_RTOL[torch.float32]} (f32), {FLASH_RTOL[torch.bfloat16]} "
          f"(bf16, half an ulp), inputs N(0, 1)")
    for i, shape in enumerate(shapes):
        name, count, b, s, causal, window, _ = shape[:7]
        q, k, v = flash_inputs(seed + i, shape, cfg)
        rows.append({**flash_held(name, q, k, v, flash_kw(shape, cfg)),
                     "per_forward": count, "batch": b, "S": s,
                     "T": key_len(shape), "causal": causal,
                     "window": window})
        del q, k, v
    return rows


def flash_head_dim_check(seed: int, shapes, dtype) -> list[dict]:
    """The kernel of ``dtype`` at the head dims of ``shapes``: each shape
    held per element against the plain version (``flash_held``); in f32
    (the CUDA-core kernel at every head dim it is built for) launched twice
    more with its statistics, the two outputs and log-sum-exps bit-equal
    and the log-sum-exp within FLASH_ATOL of the plain version's."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ref import attention_ref
    tag = "_f32" if dtype == torch.float32 else ""
    rows = []
    for i, (name, bh, bkv, s, t, hd, causal, window,
            softcap) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(seed + i)
        q, k, v = (torch.randn(n, L, hd, generator=g, device="cuda").to(dtype)
                   for n, L in ((bh, s), (bkv, t), (bkv, t)))
        kw = dict(causal=causal, window=window, softcap=softcap)
        row = {**flash_held(name + tag, q, k, v, kw), "S": s, "T": t,
               "head_dim": hd}
        if dtype == torch.float32:
            (out, lse, _), (out2, lse2, _) = (
                FA.flash_attention_kernel(q, k, v, **kw, stats=True)
                for _ in range(2))
            torch.cuda.synchronize()
            same = torch.equal(out, out2) and torch.equal(lse, lse2)
            _, ref_lse, _ = attention_ref(q, k, v, **kw, stats=True)
            lse_err = (lse - ref_lse).abs().max().item()
            print(f"[flash] {name + tag:27s} with statistics: two launches "
                  f"bit-equal {same}, lse max_abs_err {lse_err:.3e} (limit "
                  f"{FLASH_ATOL})")
            check(same, f"{name}{tag}: two launches differ")
            check(lse_err <= FLASH_ATOL, f"{name}{tag}: lse err "
                  f"{lse_err:.3e}")
            row.update(bit_equal=same, lse_max_abs_err=lse_err)
        rows.append(row)
    return rows


def top2(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per position: the argmax and the margin of the top logit over the
    second, for logits (..., vocab)."""
    v, idx = logits.topk(2, dim=-1)
    return idx[..., 0], v[..., 0] - v[..., 1]


def margin_agree(top: torch.Tensor, ref_top: torch.Tensor,
                 ref_margin: torch.Tensor, limit: float) -> tuple[bool, int]:
    """Top-1 equal wherever the reference's top-2 margin exceeds ``limit``;
    returns (all equal there, how many positions that is)."""
    sure = ref_margin > limit
    return bool((top[sure] == ref_top[sure]).all()), int(sure.sum())


def check_launches(expect: dict[str, int], what: str,
                   route: str | None = None,
                   bwd_route: str | None = None,
                   conv_route: str = "f32") -> dict[str, int]:
    """The counts since ``zero_launches``: exactly ``expect`` of each kernel
    it names, none of the others, every flash launch on ``route``, every
    flash backward launch on ``bwd_route`` (by default that route's
    backward) and every fused-conv launch on ``conv_route``."""
    got = launch_counts()
    want = {name: expect.get(name, 0) for name in got}
    check(got == want, f"{what}: kernel launches {got}, want {want}")
    conv = dict(kernel_modules()["fused_conv"].launches_by_route)
    want_conv = {r: want["fused_conv"] if r == conv_route else 0
                 for r in conv}
    check(conv == want_conv, f"{what}: fused_conv launches by route {conv}, "
          f"want {want_conv}")
    FA = kernel_modules()["flash_attention"]
    routes = dict(FA.launches_by_kernel)
    want_routes = dict.fromkeys(routes, 0)
    if route is not None:
        want_routes[route] = want["flash_attention"]
        want_routes[bwd_route or FA.BACKWARD_ROUTE[route]] = \
            want["flash_attention_bwd"]
    check(routes == want_routes, f"{what}: flash launches by route {routes}, "
          f"want {want_routes}")
    return got


@contextlib.contextmanager
def recording_routes():
    """Records, per MoE layer of the forwards run inside, the top-k choices,
    the dropped assignments and the smallest gap between the K-th and
    (K+1)-th router probability, from each ``moe.route`` result (the
    function is wrapped; what it returns is unchanged)."""
    from repro_torch.models import moe
    log, route = [], moe.route

    def recorded(p, xt, cfg):
        r = route(p, xt, cfg)
        top = r.probs.topk(cfg.moe_top_k + 1, dim=-1).values
        log.append({"sel": r.sel, "C": r.C,
                    "dropped": int((~r.keep).sum().item()),
                    "min_gap": (top[:, -2] - top[:, -1]).min().item()})
        return r
    moe.route = recorded
    try:
        yield log
    finally:
        moe.route = route


def routing_report(cfg, run: list[dict], other: list[dict],
                   what: str) -> dict:
    """Per MoE layer: the top-k selections of ``run`` that ``other`` (the
    same forward on another path) did not make, each run's dropped
    assignments, and the smallest top-k gap; printed and returned."""
    E = cfg.moe_num_experts

    def chosen(sel):
        return F.one_hot(sel, E).sum(dim=1)
    flips = [int((chosen(a["sel"]) != chosen(b["sel"])).sum().item()) // 2
             for a, b in zip(run, other)]
    out = {"capacity": run[0]["C"] if run else None,
           "flips_per_layer": flips,
           "dropped_per_layer": [r["dropped"] for r in run],
           f"dropped_per_layer_{what}": [r["dropped"] for r in other],
           "min_gap_per_layer": [r["min_gap"] for r in run],
           "min_gap": min((r["min_gap"] for r in run), default=None)}
    T = run[0]["sel"].shape[0] if run else 0
    print(f"[moe] {cfg.name}: {len(run)} MoE layers, {T} tokens, top "
          f"{cfg.moe_top_k} of {E}, capacity {out['capacity']}; top-k "
          f"selections that differ from the {what} run per layer {flips} "
          f"(sum {sum(flips)} of {T * cfg.moe_top_k * len(run)}); dropped "
          f"assignments per layer {out['dropped_per_layer']} ({what} run "
          f"{out[f'dropped_per_layer_{what}']}); smallest gap between the "
          f"K-th and (K+1)-th router probability {out['min_gap']:.3e} (per "
          f"layer {[float(f'{g:.2e}') for g in out['min_gap_per_layer']]})")
    return out


def host_init(cfg) -> list:
    """Starts drawing ``cfg``'s weights from SEED on the CPU, in a thread of
    its own, while other phases run (the CPU generator draws one normal
    after another, and releases the GIL): deepseek-moe-16b's 16.4 billion
    took 156 s on the card's host.  They are the values ``model.init``
    draws for the card (drawn on the CPU and cast there, then moved).
    Returns a box that ``prefill_path(params=...)`` empties."""
    import concurrent.futures

    from repro_torch.models import build_model
    pool = concurrent.futures.ThreadPoolExecutor(1)
    box = [pool.submit(lambda: build_model(cfg, device="cpu").init(
        seed=SEED).params)]
    pool.shutdown(wait=False)
    return box


def prefill_path(cfg, seq: int, expect: dict[str, int],
                 limit: float | None = PREFILL_ATOL,
                 every_position: bool = False, prefix: int = 0,
                 rows: int = 1, params: list | None = None) -> dict:
    """``cfg`` at full width, random weights from SEED, one ``rows``×``seq``
    forward (after ``prefix`` random prefix embeddings; an encoder-decoder
    also encodes ``encoder_seq_len`` random frames per row) that launches
    exactly ``expect`` of each kernel, held against the same forward under
    ``ops.plain()``: the logits within ``limit`` at the last position, or
    at ``every_position``, and top-1 equal wherever the plain margin
    exceeds ``limit``.  With ``limit`` None the comparison is printed
    (margins counted at PREFILL_ATOL) and not held.  For a config with
    experts, the routing of both forwards is compared layer by layer.
    ``params``, a box from ``host_init``, gives the weights drawn on the
    host (moved to the card here) in place of ``model.init``."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.api import param_count
    model = build_model(cfg)
    check(model.device.type == "cuda", f"built on {model.device}")
    t0 = time.perf_counter()
    if params is None:
        net, drawn = model.init(seed=SEED), "init from seed"
    else:
        net = model.bind(params.pop().result())
        drawn = "drawn on the host beside earlier phases, waited for and " \
                "moved to the card from seed"
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(net.params)
    n_bytes = sum(t.nbytes for t in net.buffers())
    enc = (f"{cfg.encoder_layers} encoder layers over "
           f"{cfg.encoder_seq_len} frames + " if cfg.is_encoder_decoder
           else "")
    print(f"[prefill] {cfg.name}: {enc}{cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.param_dtype}: {n_params / 1e9:.3f} B "
          f"parameters ({n_params}), {n_bytes / 1e9:.3f} GB of weights, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; "
          f"{drawn} {SEED} in {init_s:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows, seq),
                                     generator=g, device="cuda")}
    if prefix:
        batch["prefix_embed"] = torch.randn(
            rows, prefix, cfg.d_model, generator=g, device="cuda").to(
                getattr(torch, cfg.dtype))
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = torch.randn(
            rows, cfg.encoder_seq_len, cfg.d_model, generator=g,
            device="cuda").to(getattr(torch, cfg.dtype))
    want = (rows, seq, cfg.vocab_size)

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with recording_routes() as routes:
        logits, _ = model.forward(net, batch)
    torch.cuda.synchronize()
    launches = check_launches(expect, f"{cfg.name} prefill forward",
                              flash_route(cfg))
    check(tuple(logits.shape) == want, f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    top, _ = top2(logits)

    before = launch_counts()
    t0 = time.perf_counter()
    with ops.plain(), recording_routes() as plain_routes:
        plain, _ = model.forward(net, batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(launch_counts() == before, "ops.plain() launched a kernel")
    check(tuple(plain.shape) == want, f"plain logits {tuple(plain.shape)}")
    ref_top, ref_margin = top2(plain)
    err_last = (logits[:, -1] - plain[:, -1]).abs().max().item()
    err_all = max((logits[:, i:i + 512] - plain[:, i:i + 512]).abs().max()
                  .item() for i in range(0, seq, 512))
    big = plain.abs().max().item()
    del logits, plain
    err = err_all if every_position else err_last
    held = limit is not None
    margin = limit if held else PREFILL_ATOL
    agree, n_sure = margin_agree(top, ref_top, ref_margin, margin)
    print(f"[prefill] {cfg.name} "
          + (f"{prefix} prefix embeddings + " if prefix else "")
          + f"{rows}x{seq}: launches {launches}, flash on "
          f"{flash_route(cfg)}; peak "
          f"{peak_gb:.1f} GB; logits vs plain forward on the card "
          f"({plain_s:.1f} s): max_abs_err {err_last:.3e} at the last "
          f"position, {err_all:.3e} at any position ("
          + (f"limit {limit} {'at any' if every_position else 'at the last'}"
             f" position" if held else "printed, not held") +
          f"), |logit| max {big:.3f}; top-1 equal at {n_sure}/{rows * seq} "
          f"positions with plain margin > {margin}: {agree}; top-1 equal at "
          f"all positions: {int((top == ref_top).sum())}/{rows * seq}")
    routing = (routing_report(cfg, routes, plain_routes, "plain")
               if routes else None)
    del routes, plain_routes
    if held:
        check(err <= limit, f"prefill logits vs plain {err:.3e} > {limit}")
        check(agree, "prefill top-1 differs from plain where the margin is "
              "clear")
    return {"model": model, "net": net, "batch": batch, "launches": launches,
            "init_s": init_s, "params": n_params, "weight_bytes": n_bytes,
            "peak_gb": peak_gb,
            "plain_forward_s": plain_s, "logits_max_abs_err": err,
            "last_position_err": err_last, "any_position_err": err_all,
            "limit": limit, "positions_checked": n_sure, "prefix": prefix,
            "rows": rows, "routing": routing}


def serve_path(cfg, lm: dict, expect: dict[str, int],
               limit: float | None = PREFILL_ATOL) -> dict:
    """``run_lockstep`` on SERVE_BATCH prompts; each first token equal to
    the forward's argmax wherever its margin exceeds ``limit`` (printed at
    PREFILL_ATOL and not held when ``limit`` is None).  For a config with
    experts that forward runs at ``moe_capacity_factor = E/K``, where
    nothing drops (as in the decode steps), on the same parameters; the
    comparison with the forward at the config's own factor is printed,
    with its drops."""
    from repro_torch.models.api import DecoderLM
    from repro_torch.serve import ServeEngine
    model, net = lm["model"], lm["net"]
    ref_net = net
    if cfg.moe_num_experts:
        ref_net = DecoderLM(dataclasses.replace(
            cfg, moe_capacity_factor=cfg.moe_num_experts / cfg.moe_top_k),
            params=net.params, device=model.device)
    g = torch.Generator().manual_seed(SEED + 4)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT_LEN),
                            generator=g)
    engine = ServeEngine(model, net, batch_slots=SERVE_BATCH,
                         max_len=PROMPT_LEN + NEW_TOKENS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.run_lockstep(prompts.tolist(), NEW_TOKENS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    check(len(outs) == SERVE_BATCH and all(
        len(o) == NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in o)
        for o in outs), "engine output shape or token range")

    zero_launches()
    with recording_routes() as routes:
        logits, _ = model.forward(ref_net, {"tokens": prompts.to("cuda")})
    torch.cuda.synchronize()
    launches = check_launches(expect, f"{cfg.name} cross-check forward",
                              flash_route(cfg))
    check(all(r["dropped"] == 0 for r in routes),
          "the no-drop cross-check forward dropped assignments")
    ref_top, ref_margin = top2(logits[:, -1])
    del logits
    first = torch.tensor([o[0] for o in outs], device="cuda")
    margin = PREFILL_ATOL if limit is None else limit
    agree, n_sure = margin_agree(first, ref_top, ref_margin, margin)
    print(f"[serve] {cfg.name}: {SERVE_BATCH} prompts of {PROMPT_LEN} + "
          f"{NEW_TOKENS} new tokens through run_lockstep in {wall_s:.2f} s "
          f"({PROMPT_LEN + NEW_TOKENS} decode steps); first tokens "
          f"{first.tolist()} vs forward argmax {ref_top.tolist()} "
          + ("(at moe_capacity_factor = E/K, no drops) "
             if ref_net is not net else "")
          + f"(margins {[round(m, 3) for m in ref_margin.tolist()]}): equal "
          f"at {n_sure}/{SERVE_BATCH} clear positions: {agree}"
          + (" (printed, not held)" if limit is None else ""))
    out = {"serve_wall_s": wall_s, "serve_launches": launches,
           "first_tokens": first.tolist(), "serve_positions_checked": n_sure,
           "outputs": outs}
    if ref_net is not net:
        with recording_routes() as routes:
            logits, _ = model.forward(net, {"tokens": prompts.to("cuda")})
        own_top, own_margin = top2(logits[:, -1])
        del logits
        own_agree, own_sure = margin_agree(first, own_top, own_margin,
                                           margin)
        drops = [r["dropped"] for r in routes]
        print(f"[serve] {cfg.name}: the same against the forward at the "
              f"config's moe_capacity_factor {cfg.moe_capacity_factor} "
              f"(printed, not held): argmax {own_top.tolist()}, equal at "
              f"{own_sure}/{SERVE_BATCH} clear positions: {own_agree}; "
              f"dropped assignments per layer {drops} (capacity "
              f"{routes[0]['C']} for {SERVE_BATCH}x{PROMPT_LEN} tokens)")
        out.update(own_factor_argmax=own_top.tolist(),
                   own_factor_agree=own_agree, own_factor_drops=drops)
    if limit is not None:
        check(agree, "engine's first token differs from the forward's "
              "argmax")
    return out


def flash_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through, counted for these
    shapes: what the kernel must compute."""
    qpos = np.arange(s)
    hi = np.minimum(qpos, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(s, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bounds(shape, cfg) -> dict:
    _, _, b, s, causal, window, dtype = shape[:7]
    t = key_len(shape)
    hd, bh, bkv = cfg.resolved_head_dim, b * cfg.num_heads, \
        b * cfg.num_kv_heads
    bf16 = dtype == torch.bfloat16
    return roofline(4 * hd * bh * flash_pairs(s, t, causal, window),
                    (2 if bf16 else 4) * hd * (2 * bh * s + 2 * bkv * t),
                    PEAK_BF16_OPS if bf16 else PEAK_F32_OPS)


def flash_timings(rows: list[dict], cfg, shapes, seed: int) -> None:
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ref import attention_ref
    what = (f"it has no softcap, so at softcap {cfg.attn_softcap} it "
            f"computes another function" if cfg.attn_softcap else
            "the same function (no softcap)")
    print(f"[time] library = F.scaled_dot_product_attention with enable_gqa,"
          f" timed with the same boolean mask and, on the shapes without a "
          f"window, with no mask and is_causal set as the shape's (which "
          f"can reach a faster backend); library_ms is the faster: {what}; "
          f"a yardstick only, the port never calls it")
    for i, (shape, row) in enumerate(zip(shapes, rows)):
        _, _, b, s, causal, window, _ = shape[:7]
        t = key_len(shape)
        q, k, v = flash_inputs(seed + i, shape, cfg)
        kw = flash_kw(shape, cfg)
        qpos = torch.arange(s, device="cuda")[:, None]
        kpos = torch.arange(t, device="cuda")[None, :]
        mask = torch.ones(s, t, dtype=torch.bool, device="cuda")
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        q4 = q.view(b, -1, s, q.shape[-1])
        k4, v4 = (x.view(b, -1, t, x.shape[-1]) for x in (k, v))
        iters = FLASH_BIG_ITERS if s >= 4096 else TIMING_ITERS
        row.update(flash_bounds(shape, cfg))
        row["ms"] = cuda_ms(lambda: flash_attention_kernel(q, k, v, **kw),
                            iters=iters)
        row["plain_ms"] = cuda_ms(lambda: attention_ref(q, k, v, **kw),
                                  iters=iters)
        row["library_mask_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, enable_gqa=True), iters=iters)
        row["library_nomask_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, enable_gqa=True),
            iters=iters) if not window else None
        row["library_ms"] = min(x for x in (row["library_mask_ms"],
                                            row["library_nomask_ms"])
                                if x is not None)
        nomask_ms = (f"{row['library_nomask_ms']:.4f}"
                     if row["library_nomask_ms"] is not None else "-")
        print(f"[time] {row['name']:27s} x{row['per_forward']:<2d} kernel "
              f"{row['ms']:.4f} ms ({row['ops'] / row['ms'] / 1e9:.1f} "
              f"TFLOP/s)  plain {row['plain_ms']:.4f}  library mask "
              f"{row['library_mask_ms']:.4f} is_causal={causal} "
              f"{nomask_ms}  bound {row['bound_ms']:.4f} "
              f"({row['bound_by']})")
        del q, k, v, q4, k4, v4, mask


# What the names of an op's device kernels contain, where not the op's name.
DEVICE_KERNELS = {"mlstm_scan": ("mlstm_gates_scores_kernel",
                                 "mlstm_chunk_carry_kernel",
                                 "mlstm_state_pass_kernel",
                                 "mlstm_chunk_output_kernel")}


def lm_timings(cfg, lm: dict, seq: int, profile_lm: dict | None = None
               ) -> dict:
    """The prefill and a decode step with CUDA events, and one prefill
    under torch.profiler: of ``profile_lm``'s model where given (a
    depth-cut copy, for a forward whose events would take minutes to
    read)."""
    from torch.profiler import ProfilerActivity, record_function
    model, net, batch = lm["model"], lm["net"], lm["batch"]
    prefill_ms = cuda_ms(lambda: model.forward(net, batch), iters=3,
                         warmup=1)
    rows = batch["tokens"].shape[0]
    cache = model.init_cache(SERVE_BATCH, PROMPT_LEN + NEW_TOKENS)
    tok = torch.zeros(SERVE_BATCH, 1, dtype=torch.long, device="cuda")
    decode_ms = cuda_ms(lambda: model.decode_step(net, cache, tok,
                                                  PROMPT_LEN), iters=10)
    print(f"[time] {cfg.name} prefill {rows}x{seq}: {prefill_ms:.2f} ms "
          f"({rows * seq / prefill_ms * 1e3:.0f} tokens/s; CUDA events, mean "
          f"of 3); decode step at batch {SERVE_BATCH}: {decode_ms:.3f} ms "
          f"({SERVE_BATCH / decode_ms * 1e3:.1f} tokens/s; mean of 10)")

    pl = profile_lm or lm
    if profile_lm is not None:       # ``lm``'s model is warm from cuda_ms
        pl["model"].forward(pl["net"], pl["batch"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with record_function("prefill"), annotated_moe():
            pl["model"].forward(pl["net"], pl["batch"])
            torch.cuda.synchronize()
    events = prof.events()
    profile_s = time.perf_counter() - t0
    print(f"[profile] {pl['model'].cfg.name} prefill "
          f"({pl['model'].cfg.num_layers} layers): {len(events)} events "
          f"recorded and read in {profile_s:.1f} s")
    out = {"prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
           "decode_tokens_per_s": SERVE_BATCH / decode_ms * 1e3,
           "profile_events": len(events), "profile_s": profile_s,
           "prefill_profile": device_breakdown(events, "prefill", 1)}
    prof_ = out["prefill_profile"]
    if prof_ is not None and cfg.moe_num_experts:
        prof_["split_us"] = moe_split(events, prof_)
    del events
    if prof_ is not None:
        for name, n in pl["launches"].items():
            if not n:
                continue
            marks = DEVICE_KERNELS.get(name, (name,))
            us = sum(k["us"] for k in prof_["all_kernels"]
                     if any(mark in k["name"] for mark in marks))
            prof_[f"{name}_share_of_busy"] = us / prof_["device_busy_us"]
            print(f"[profile] prefill: {name} kernel {us / 1e3:.2f} ms of "
                  f"{prof_['device_busy_us'] / 1e3:.2f} ms device busy "
                  f"({us / prof_['device_busy_us']:.3f})")
        print(f"[profile] prefill: idle share {prof_['idle_share']:.3f}")
        del prof_["all_kernels"]

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with record_function("decode_step"):
            model.decode_step(net, cache, tok, PROMPT_LEN)
            torch.cuda.synchronize()
    out["decode_profile"] = device_breakdown(prof.events(), "decode_step", 1)
    if out["decode_profile"] is not None:
        out["decode_profile"]["launches"] = sum(
            k["count"] for k in out["decode_profile"].pop("all_kernels"))
        print(f"[profile] decode step: {out['decode_profile']['launches']} "
              f"device kernels")
    return out


# The profiler ranges annotated_moe puts around the MoE's four steps;
# their device-side copies are not kernels.
MOE_RANGES = {"route": "moe_route", "dispatch": "moe_dispatch",
              "experts": "moe_experts", "combine": "moe_combine"}
ANNOTATIONS = set(MOE_RANGES.values())


@contextlib.contextmanager
def annotated_moe():
    """Wraps each call of the MoE's four steps (``repro_torch.models.moe``'s
    route, dispatch, experts and combine) in a profiler range, so that
    ``moe_split`` can tell their kernels apart."""
    from torch.profiler import record_function

    from repro_torch.models import moe
    steps = {name: getattr(moe, name) for name in MOE_RANGES}

    def annotated(name):
        def step(*args):
            with record_function(MOE_RANGES[name]):
                return steps[name](*args)
        return step
    for name in steps:
        setattr(moe, name, annotated(name))
    try:
        yield
    finally:
        for name, fn in steps.items():
            setattr(moe, name, fn)


MOE_SPLIT = ("flash", "expert_gemms", "other_gemms", "moe_dispatch_combine",
             "expert_activations", "rest")


def moe_split(events, prof_: dict) -> dict[str, float]:
    """Device time (us) of one prefill's kernels by what launched them:
    flash, by kernel name (its ctypes launch is linked to no host op); the
    rest by the host op the profiler links each kernel to and the MoE step
    around it: the routed experts' GEMMs (``aten::bmm`` in ``experts``),
    the other GEMMs (``aten::mm``, ``aten::addmm``: projections, router,
    shared experts, head), the MoE's routing, dispatch and combine (every
    other kernel in ``route``, ``dispatch`` and ``combine``: softmax,
    top-k, one-hot, cumsum, scatter, gather, gate products), the experts'
    activations, and the rest.  What neither accounts for is
    ``unlinked``."""
    split = dict.fromkeys(MOE_SPLIT, 0.0)
    split["flash"] = sum(k["us"] for k in prof_["all_kernels"]
                         if "flash_attention" in k["name"])
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        step, q = None, e
        while q is not None and step is None:
            step = q.name if q.name in MOE_RANGES.values() else None
            q = q.cpu_parent
        for k in e.kernels:
            if "flash_attention" in k.name:
                continue
            if e.name == "aten::bmm":
                what = "expert_gemms"
            elif e.name in ("aten::mm", "aten::addmm"):
                what = "other_gemms"
            elif step == "moe_experts":
                what = "expert_activations"
            else:
                what = "rest" if step is None else "moe_dispatch_combine"
            split[what] += k.duration
    kernels_us = sum(k["us"] for k in prof_["all_kernels"])
    split["unlinked"] = kernels_us - sum(split.values())
    busy = prof_["device_busy_us"]
    print("[profile] prefill device time by what launched it: " + ", ".join(
        f"{k} {v / 1e3:.2f} ms ({v / busy:.3f} of busy)"
        for k, v in split.items()))
    return split


# --- zamba2-2.7b: the SSD-scan kernel -------------------------------------------

def scan_inputs(i: int, shape, cfg):
    from repro_torch.models.ssm import ssm_dims
    _, _, b, s, a_log = shape
    _, H, P, N = ssm_dims(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 400 + i)

    def randn(*size):
        return torch.randn(size, generator=g, device="cuda")
    dtx = randn(b, s, H, P) * 0.3
    if a_log is None:
        a = -F.softplus(randn(b, s, H))
    elif a_log == "long":
        lo, hi = np.log(LONG_DT[0]), np.log(LONG_DT[1])
        dt = torch.exp(lo + (hi - lo) * torch.rand((b, s, H), generator=g,
                                                    device="cuda"))
        a = -dt * torch.linspace(*LONG_A, H, device="cuda")
    else:
        a = torch.full((b, s, H), a_log, device="cuda")
    return dtx, a, randn(b, s, N) * 0.3, randn(b, s, N) * 0.3


def scan_dtype_check(tag: str, op: str, plain, args: tuple, bf16: tuple,
                     limit: float) -> dict:
    """``ops.<op>`` on the card with the operands ``bf16`` names rounded to
    bf16 (the gates stay f32): one kernel launch, the first operand's dtype
    out, as JAX's ops give, and every element within one bf16 ulp of the
    plain version on the f32 copies plus ``limit``."""
    from repro_torch.kernels import ops
    args = tuple(a.bfloat16() if i in bf16 else a for i, a in enumerate(args))
    mod = kernel_modules()[op]
    before = mod.launches
    out = getattr(ops, op)(*args)
    torch.cuda.synchronize()
    check(mod.launches == before + 1 and out.dtype == torch.bfloat16,
          f"{op} on bf16: {mod.launches - before} launches, {out.dtype}")
    ref = plain(*(a.float() for a in args))
    err = (out.float() - ref).abs()
    used = (err / (BF16_ULP * ref.abs() + limit)).max().item()
    print(f"[{tag}] bf16 operands {tuple(args[0].shape)}: out {out.dtype}, "
          f"max_abs_err {err.max().item():.3e} against the plain version on "
          f"f32 copies, limit used {used:.3f} (one bf16 ulp + {limit})")
    check(used <= 1, f"{op} on bf16 uses {used:.3f} of its limit")
    return {"shape": list(args[0].shape), "dtype": str(out.dtype),
            "max_abs_err": err.max().item(), "limit_used": used}


def scan_closed_form(shape, dtx, a, Bm, Cm):
    """The full reset (a_log = -30): y_t = (C_t·B_t)·dtx_t."""
    return (Cm * Bm).sum(-1)[..., None, None] * dtx \
        if isinstance(shape[4], float) else None


def recurrence_check(tag: str, kernel, plain, shapes, inputs, closed_form,
                     limit: float, closed_note: str, twice: bool = False,
                     exact=None) -> list[dict]:
    """Each shape's kernel output against its plain version, both f32 on
    the card, within ``limit`` per element; where ``closed_form`` gives one
    for the shape, against that too; with ``twice``, a second launch must
    give the same bits; with ``exact`` (the recurrence in f64), both
    distances from it are printed and recorded, not held."""
    rows = []
    print(f"[{tag}] limit, per element against the plain version in f32: "
          f"|kernel - plain| <= {limit}; {closed_note}"
          + ("; two launches bit-equal" if twice else ""))
    for i, shape in enumerate(shapes):
        name, count, b, s = shape[:4]
        args = inputs(i, shape)
        out = kernel(*args)
        again = kernel(*args) if twice else out
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"{name}: two launches differ")
        ref = plain(*args)
        check(out.shape == ref.shape and out.dtype == torch.float32,
              f"{name}: {out.shape} {out.dtype} vs {ref.shape}")
        err = (out - ref).abs().max().item()
        row = {"name": name, "per_forward": count, "batch": b, "S": s,
               "max_abs_err": err, "limit_used": err / limit,
               "max_abs_out": ref.abs().max().item()}
        if exact is not None:
            ref64 = exact(*args)
            row["kernel_vs_f64"] = (out.double() - ref64).abs().max().item()
            row["plain_vs_f64"] = (ref.double() - ref64).abs().max().item()
            del ref64
        closed = closed_form(shape, *args)
        if closed is not None:
            row["closed_form_err"] = (out - closed).abs().max().item()
            check(row["closed_form_err"] <= limit,
                  f"{name}: kernel vs closed form "
                  f"{row['closed_form_err']:.3e}")
        print(f"[{tag}] {name:19s} {tuple(args[0].shape)} max_abs_err "
              f"{err:.3e} (|out| max {row['max_abs_out']:.3f}) limit used "
              f"{row['limit_used']:.4f}"
              + (f"; vs closed form {row['closed_form_err']:.3e}"
                 if closed is not None else "")
              + (f"; vs f64: kernel {row['kernel_vs_f64']:.3e}, plain "
                 f"{row['plain_vs_f64']:.3e}" if exact is not None else ""))
        check(err <= limit, f"{name}: kernel vs plain {err:.3e} > {limit}")
        rows.append(row)
        del args, out, again, ref, closed
    return rows


def scan_bounds(shape, cfg) -> dict:
    """Each input read and output written once, and the operations the
    function needs: the fewer of two ways to compute it, the chunked form
    at the kernel's chunk, with the masked scores C·Bᵀ (upper half
    skipped) formed once per (batch, chunk) since every head shares B and
    C, and per head the decay-weighted scores times dtx, the inter term and
    the carry; or the sequential recurrence at 5·N·P a step and head.  The
    bound is the kernel's: that work as three bf16 products on the tensor
    cores, against the bytes; ``bound_f32_ms`` is the same work in f32 on
    the CUDA cores; ``ops`` is the f32 work, for TFLOP/s."""
    from repro_torch.models.ssm import ssm_dims
    _, _, b, s, _ = shape
    _, H, P, N = ssm_dims(cfg)
    lens = [min(SCAN_CHUNK, s - t0) for t0 in range(0, s, SCAN_CHUNK)]
    chunked = b * sum(L * (L + 1) * N + H * (L * (L + 1) * P + 4 * L * N * P)
                      for L in lens)
    recurrence = b * H * s * 5 * N * P
    form = f"chunked at {SCAN_CHUNK}" if chunked < recurrence else \
        "recurrence"
    ops = min(chunked, recurrence)
    nbytes = 4 * b * s * (2 * H * P + H + 2 * N)
    f32 = roofline(ops, nbytes)
    return {**roofline(3 * ops, nbytes, peak=PEAK_BF16_OPS), "ops": ops,
            "ops_form": form, "bound_f32_ms": f32["bound_ms"],
            "bound_f32_by": f32["bound_by"]}


def recurrence_timings(rows: list[dict], shapes, inputs, kernel, plain,
                       bounds, what: str) -> None:
    """Per shape the kernel, its plain version (one step at a time: a few
    kernels per step, so few runs at long S) and the bound."""
    print(f"[time] library: none; no single PyTorch call computes {what}")
    for i, (shape, row) in enumerate(zip(shapes, rows)):
        args = inputs(i, shape)
        row.update(bounds(shape))
        row["ms"] = cuda_ms(lambda: kernel(*args))
        row["plain_ms"] = cuda_ms(lambda: plain(*args),
                                  iters=2 if shape[3] >= 1000 else 5,
                                  warmup=1)
        row["library_ms"] = None
        f32 = (f"; f32 CUDA cores {row['bound_f32_ms']:.4f} "
               f"({row['bound_f32_by']})" if "bound_f32_ms" in row else "")
        print(f"[time] {row['name']:19s} x{row['per_forward']:<2d} kernel "
              f"{row['ms']:.4f} ms ({row['ops'] / row['ms'] / 1e9:.2f} "
              f"TFLOP/s)  plain {row['plain_ms']:.3f}  bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']}; {row['ops']:.4g} "
              f"operations, {row['ops_form']}{f32})")
        del args


# --- xlstm-1.3b: the mLSTM-scan kernel ------------------------------------------

def mlstm_inputs(i: int, shape, cfg):
    _, _, b, s, f_pre, i_scale = shape
    H, P = cfg.num_heads, cfg.d_model // cfg.num_heads
    g = torch.Generator(device="cuda").manual_seed(SEED + 500 + i)

    def randn(*size):
        return torch.randn(size, generator=g, device="cuda")
    q, k, v = (randn(b, s, H, P) * 0.4 for _ in range(3))
    i_pre = randn(b, s, H) * i_scale
    if isinstance(f_pre, float):
        f = torch.full((b, s, H), f_pre, device="cuda")
    else:
        f = randn(b, s, H) + (4 if f_pre == "long" else 2)
    return q, k, v, i_pre, f


MLSTM_CLOSED_NOTE = ("the forget-all shape also against v_t (k_t.q_t) / "
                     "max(|k_t.q_t|, 1)")


def mlstm_closed_form(shape, q, k, v, i_pre, f_pre):
    """Forget-all (f_pre = -30): h_t = v_t (k_t·q_t) / max(|k_t·q_t|, 1)."""
    if not isinstance(shape[4], float):
        return None
    kq = (k * q).sum(-1, keepdim=True)
    return v * kq / kq.abs().clamp_min(1.0)


def in_f64(plain):
    """``plain`` (a plain recurrence of ``kernels/ref.py``) on its inputs
    cast to f64: the recurrence in f64."""
    return lambda *args: plain(*(t.double() for t in args))


def mlstm_ops(b: int, s: int, H: int, P: int) -> tuple[int, str]:
    """The fewest operations the function needs, and the form that needs
    them: the recurrence at 5·P² + 5·P a step and head (C's rank-1 update
    3·P², C·q 2·P², n and n·q 5·P), or the chunked form at a chunk of L
    steps, per chunk and head 2·L(L+1)·P for the causal scores and their
    weighted values, (4·L + 1)·P² for the inter-chunk product and the carry
    of C, and O(L² + L·P) for the gates, n and the division."""
    best, form = b * H * s * (5 * P * P + 5 * P), "recurrence"
    for Q in MLSTM_CHUNKS:
        lens = [min(Q, s - t0) for t0 in range(0, s, Q)]
        chunked = b * H * sum(2 * L * (L + 1) * P + 3 * L * (L + 1) // 2
                              + (4 * L + 1) * P * P + 7 * L * P + P
                              for L in lens)
        if chunked < best:
            best, form = chunked, f"chunked at {Q}"
    return best, form


def mlstm_kernel_ms(b: int, s: int, H: int, P: int) -> tuple[float, int]:
    """The least time the kernel's arithmetic could take, and the chunk at
    which: per chunk of L steps and head the causal scores (L(L+1)·P) in
    f64 on the FP64 tensor cores, at the f32 CUDA cores' 67 TFLOP/s; the
    carry, the inter-chunk product and the weighted scores times V (4·L·P²
    + L(L+1)·P) as three TF32 products at 495 TFLOP/s; the rest of
    ``mlstm_ops``'s chunked form at 67 TFLOP/s."""
    best = None
    for Q in MLSTM_CHUNKS:
        scores = tc = rest = 0
        for t0 in range(0, s, Q):
            L = min(Q, s - t0)
            scores += L * (L + 1) * P
            tc += 4 * L * P * P + L * (L + 1) * P
            rest += 3 * L * (L + 1) // 2 + P * P + 7 * L * P + P
        ms = b * H * ((scores + rest) / PEAK_F32_OPS
                      + 3 * tc / PEAK_TF32_OPS) * 1e3
        if best is None or ms < best[0]:
            best = (ms, Q)
    return best


def mlstm_bounds(shape, cfg) -> dict:
    """Each input read and h written once; the kernel's bound (its
    arithmetic as ``mlstm_kernel_ms`` counts it, against the bytes) and, as
    ``bound_f32_ms``, the f32 work of ``mlstm_ops`` on the CUDA cores;
    ``ops`` is the f32 work, for TFLOP/s."""
    _, _, b, s, _, _ = shape
    H, P = cfg.num_heads, cfg.d_model // cfg.num_heads
    ops_, form = mlstm_ops(b, s, H, P)
    nbytes = 4 * b * s * H * (4 * P + 2)
    f32 = roofline(ops_, nbytes)
    ops_ms, chunk = mlstm_kernel_ms(b, s, H, P)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"ops": ops_, "bytes": nbytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_chunk": chunk, "ops_form": form,
            "bound_f32_ms": f32["bound_ms"], "bound_f32_by": f32["bound_by"]}


def lm_record(*parts: dict) -> dict:
    return {k: v for part in parts for k, v in part.items()
            if k not in ("model", "net", "batch")}


def per_forward(rows: list[dict], key: str) -> float:
    return sum(r["per_forward"] * r[key] for r in rows)


def conv_times() -> None:
    """Per conv shape of one forward, the fused conv's CUDA-event and device
    time, and their sums over the forward; then, where the checkout has the
    bf16 route, the same on it beside the plain version, cuDNN's bf16 conv,
    both bounds and TFLOP/s (``shape_timings``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_conv as fc
    from repro_torch.kernels.fused_conv import fused_conv_kernel
    _build.library()
    total = {"events": 0.0, "device": 0.0}
    measured = True
    for i, shape in enumerate(CONV_SHAPES):
        name, count, _, _, _, _, s, p, relu, _ = shape
        x, w, scale, shift, res = conv_inputs(i, shape)
        kw = dict(stride=s, padding=p, relu=relu, residual=res)

        def call():
            return fused_conv_kernel(x, w, scale, shift, **kw)
        ms, dev = cuda_ms(call), device_ms(call)
        total["events"] += count * ms
        total["device"] += count * (dev or 0.0)
        measured = measured and dev is not None
        print(f"[conv] {name:16s} x{count} events {ms:.4f} ms  on the card "
              f"{fmt_ms(dev)}")
    print(f"[conv] per forward: events {total['events']:.4f} ms, on the card "
          f"{fmt_ms(total['device'] if measured else None)}")
    if not hasattr(fc, "K_BLOCKS"):   # a checkout without the bf16 route
        return
    rows = [{"name": shape[0], "per_forward": shape[1],
             **dict(zip(("tile_n", "splits"), conv_plan(shape, "bf16")))}
            for shape in CONV_SHAPES]
    shape_timings(rows, conv16_inputs, bounds_bf16, "bf16 ")
    measured = all(r["device_ms"] is not None for r in rows)
    print(f"[conv] bf16 per forward: events {per_forward(rows, 'ms'):.4f} "
          f"ms, on the card "
          f"{fmt_ms(per_forward(rows, 'device_ms') if measured else None)}"
          f", bound {per_forward(rows, 'bound_ms'):.4f} (operations "
          f"{per_forward(rows, 'ops_ms'):.4f}, bytes "
          f"{per_forward(rows, 'bytes_ms'):.4f}), cuDNN bf16 on the card "
          + fmt_ms(per_forward(rows, 'library_device_ms')
                   if all(r["library_device_ms"] is not None for r in rows)
                   else None))


def flash_bwd_times() -> None:
    """The flash backward kernels alone (``flash_attention_backward_kernel``
    on the forward kernel's saved statistics) at every shape of phase 34's
    GRAD_SHAPES, the first minicpm-2b's layer (the f32 twin's in f32) and
    the fourth zamba2-2.7b's, in bf16 and in f32, then in bf16 at gemma2's
    training shapes (GEMMA2_GRAD_SHAPES) and paligemma-3b's heads
    (PALIGEMMA_GRAD_SHAPE): CUDA-event and device
    time, the device time of each device kernel, the bound (10·D operations
    a visible pair at 989 TFLOP/s in bf16, 67 in f32, against each input
    read and each output written once at 3.35 TB/s) and SDPA's backward
    alone where it computes the same function (no window, no softcap;
    ``enable_gqa`` for GQA; in f32 with TF32 off), timed as a yardstick the
    port never calls.  Then the f32 forward kernel (``simt_f32``) against
    SDPA's f32 forward at the twin's layer, at whisper's two f32 clip
    shapes and at phase 34's other head dims, with its bound (4·D a pair at
    67 TFLOP/s).  Only the wrappers'
    signatures are used, so a copy of this file beside an older checkout
    times that checkout's kernels."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    _build.library()
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        tag, size = ("bf16", 2) if bf16 else ("f32", 4)
        shapes = GRAD_SHAPES + (GEMMA2_GRAD_SHAPES + [PALIGEMMA_GRAD_SHAPE]
                                if bf16 else [])
        for i, (name, B, H, KV, S, T, D, causal, window,
                softcap) in enumerate(shapes):
            g = torch.Generator(device="cuda").manual_seed(SEED + 970 + i)
            q, k, v, do = (torch.randn(B * heads, n, D, generator=g,
                                       device="cuda").to(dtype)
                           for heads, n in ((H, S), (KV, T), (KV, T),
                                            (H, S)))
            kw = dict(causal=causal, window=window, softcap=softcap)
            out, lse, lo = FA.flash_attention_kernel(q, k, v, **kw,
                                                     stats=True)

            def call():
                return FA.flash_attention_backward_kernel(
                    q, k, v, out, lse, do, out_lo=lo, **kw)
            ms = cuda_ms(call)
            by_kernel = device_ms_by_kernel(call) or {}
            pairs = B * H * flash_pairs(S, T, causal, window)
            # q, O (and in bf16 O's lo part), dO and dq; k, v, dk, dv; the
            # f32 lse
            bound = roofline(10 * D * pairs,
                             size * D * ((5 if bf16 else 4) * B * H * S
                                         + 4 * B * KV * T) + 4 * B * H * S,
                             PEAK_BF16_OPS if bf16 else PEAK_F32_OPS)
            library = None
            if not window and not softcap:
                # (B, heads, rows, D) views of (B, rows, heads, D) tensors,
                # the model's layout, as phase 38 hands them to SDPA
                q4, k4, v4, do4 = (
                    t.view(B, -1, t.shape[1], D).transpose(1, 2).contiguous()
                    .transpose(1, 2) for t in (q, k, v, do))
                q4, k4, v4 = (t.requires_grad_() for t in (q4, k4, v4))
                out4 = F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, enable_gqa=H != KV)
                library = cuda_ms(lambda: torch.autograd.grad(
                    out4, (q4, k4, v4), do4, retain_graph=True))
                del q4, k4, v4, do4, out4
            device = sum(by_kernel.values()) if by_kernel else None
            parts = ", ".join(f"{n.split('(')[0]} {t:.4f}"
                              for n, t in sorted(by_kernel.items()))
            print(f"[flash-bwd] {name}_{tag} {B}x{H}/{KV} heads S={S} T={T} "
                  f"D={D} causal={causal} window={window} softcap={softcap}"
                  f": events {ms:.4f} ms, on the card {fmt_ms(device)} "
                  f"({parts}); bound {bound['bound_ms']:.4f} ms "
                  f"({bound['bound_by']}; 10*D a pair {bound['ops_ms']:.4f},"
                  f" bytes {bound['bytes_ms']:.4f}), "
                  f"{bound['ops'] / ms / 1e9:.1f} TFLOP/s of the 10*D; "
                  f"SDPA's backward alone {fmt_ms(library)}")
            del q, k, v, do, out, lse, lo
        torch.cuda.empty_cache()
    flash_f32_forward_times()


def flash_f32_forward_times() -> None:
    """The f32 flash forward kernel (``simt_f32``, no statistics, as on the
    serving paths) against SDPA's f32 forward (TF32 off, no mask,
    ``is_causal`` as the shape's, ``enable_gqa`` for GQA: the same function
    where the shape has no window and no softcap) at the minicpm-2b f32
    twin's layer, at whisper-large-v3's two f32 clip shapes (phase 28's f32
    rows) and at phase 34's other head dims (qwen3's GQA at D = 128,
    gemma2's D = 256 with window and softcap, zamba2's D = 80): CUDA
    events, device time, the bound (4·D operations a visible pair at 67
    TFLOP/s against q, k, v read and O written once)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    cfg, wcfg = get_config(TRAIN_CONFIG), get_config(WHISPER_CONFIG)
    shapes = [(f"{cfg.name}_f32_twin_layer", TRAIN_ROWS, cfg.num_heads,
               cfg.num_heads, TRAIN_SEQ, TRAIN_SEQ, cfg.resolved_head_dim,
               True, 0, 0.0)] + [
        (f"whisper_{name}", b, wcfg.num_heads, wcfg.num_heads, s, t,
         wcfg.resolved_head_dim, causal, 0, 0.0)
        for name, _, b, s, causal, _, dtype, t in WHISPER_FLASH_SHAPES
        if dtype == torch.float32] + [
        shape for shape in GRAD_SHAPES if shape[6] != 64]
    for i, (name, B, H, KV, S, T, D, causal, window,
            softcap) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(SEED + 990 + i)
        q4, k4, v4 = (torch.randn(B, n_heads, n, D, generator=g,
                                  device="cuda")
                      for n_heads, n in ((H, S), (KV, T), (KV, T)))
        q, k, v = (t.reshape(-1, t.shape[2], D) for t in (q4, k4, v4))
        kw = dict(causal=causal, window=window, softcap=softcap)

        def call():
            return FA.flash_attention_kernel(q, k, v, **kw)
        ms = cuda_ms(call)
        device = device_ms(call)
        library = library_device = None
        if not window and not softcap:
            def sdpa():
                return F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, enable_gqa=H != KV)
            library, library_device = cuda_ms(sdpa), device_ms(sdpa)
        bound = roofline(4 * D * B * H * flash_pairs(S, T, causal, window),
                         4 * D * B * (2 * H * S + 2 * KV * T))
        sdpa = (f"SDPA f32 (TF32 off) events {library:.4f} ms, on the card "
                f"{fmt_ms(library_device)}" if library else
                "SDPA: not the same function (window or softcap)")
        ratio = f"; kernel / SDPA {ms / library:.3f}" if library else ""
        print(f"[flash-fwd] {name}_f32 {B}x{H}/{KV} heads S={S} T={T} D={D} "
              f"causal={causal} window={window} softcap={softcap}: "
              f"simt_f32 events {ms:.4f} ms, on the card {fmt_ms(device)}; "
              f"{sdpa}; bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}; 4*D a pair {bound['ops_ms']:.4f}, "
              f"bytes {bound['bytes_ms']:.4f}); "
              f"{bound['ops'] / ms / 1e9:.1f} TFLOP/s of the 4*D{ratio}")
        del q4, k4, v4, q, k, v
    torch.cuda.empty_cache()


def recurrence_times(tag: str, module, kernel, plain, shapes, inputs,
                     closed_form, limit: float, note: str, bounds,
                     ops_label: str, exact=None) -> None:
    """Per shape, the kernel held against its plain version (``limit``,
    two launches bit-equal), then its CUDA-event and device time, the
    device time of each of its device kernels, and the sums over one
    prefill; at every chunk the wrapper ``module`` is built for (one pass
    for a wrapper without chunks)."""
    import functools
    for chunk in getattr(module, "BUILT_CHUNKS", (None,)):
        fn = kernel if chunk is None else functools.partial(kernel,
                                                            chunk=chunk)
        label = tag if chunk is None else f"{tag} chunk {chunk}"
        rows = recurrence_check(label, fn, plain, shapes, inputs, closed_form,
                                limit, note, twice=True, exact=exact)
        total = {"events": 0.0, "device": 0.0}
        measured = True
        for i, (shape, row) in enumerate(zip(shapes, rows)):
            args = inputs(i, shape)
            ms = cuda_ms(lambda: fn(*args))
            by_kernel = device_ms_by_kernel(lambda: fn(*args))
            dev = None if by_kernel is None else sum(by_kernel.values())
            total["events"] += row["per_forward"] * ms
            total["device"] += row["per_forward"] * (dev or 0.0)
            measured = measured and dev is not None
            b_ = bounds(shape)
            print(f"[{label}] {row['name']:20s} x{row['per_forward']:<2d} "
                  f"events {ms:.4f} ms  on the card {fmt_ms(dev)}  bound "
                  f"{b_['bound_ms']:.4f} ({b_['bound_by']}; bytes "
                  f"{b_['bytes_ms']:.4f}, {ops_label} {b_['ops_ms']:.4f}, "
                  f"f32 CUDA cores {b_['bound_f32_ms']:.4f})")
            for name, t in sorted((by_kernel or {}).items()):
                print(f"[{label}]   {t:.4f} ms {name[:90]}")
            del args
        print(f"[{label}] per prefill: events {total['events']:.4f} ms, on "
              f"the card {fmt_ms(total['device'] if measured else None)}")


def scan_times() -> None:
    """``recurrence_times`` for the SSD scan at every shape of phase 11."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, mamba_scan
    from repro_torch.kernels.ref import mamba_scan_ref
    _build.library()
    hcfg = get_config(HYBRID_CONFIG)
    recurrence_times("scan", mamba_scan, mamba_scan.mamba_scan_kernel,
                     mamba_scan_ref, SCAN_SHAPES,
                     lambda i, shape: scan_inputs(i, shape, hcfg),
                     scan_closed_form, SCAN_ATOL, "the reset shape also "
                     "against (C_t.B_t) dtx_t",
                     lambda shape: scan_bounds(shape, hcfg), "bf16x3")


def xlstm_prefill_times() -> None:
    """xlstm-1.3b's bf16 prefill at 1 x XLSTM_PREFILL_S, full width and
    depth, random weights from SEED, through whatever ``src/repro_torch``
    lies beside this file (a copy of this script beside an older checkout
    times that checkout's, in the same call): CUDA events, mean of 3 after
    one warm-up."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(XLSTM_CONFIG)
    model = build_model(cfg)
    net = model.init(seed=SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    tokens = torch.randint(0, cfg.vocab_size, (1, XLSTM_PREFILL_S),
                           generator=g, device="cuda")
    ms = cuda_ms(lambda: model.forward(net, {"tokens": tokens}), iters=3,
                 warmup=1)
    print(f"[time] {cfg.name} bf16 prefill 1x{XLSTM_PREFILL_S} through "
          f"{ROOT / 'src'}: {ms:.2f} ms (CUDA events, mean of 3)")


def mlstm_times() -> None:
    """``recurrence_times`` for the mLSTM scan at every shape of phase 17,
    each also against the recurrence in f64."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, mlstm_scan
    from repro_torch.kernels.ref import mlstm_ref
    _build.library()
    xcfg = get_config(XLSTM_CONFIG)
    recurrence_times("mlstm", mlstm_scan, mlstm_scan.mlstm_scan_kernel,
                     mlstm_ref, MLSTM_SHAPES,
                     lambda i, shape: mlstm_inputs(i, shape, xcfg),
                     mlstm_closed_form, MLSTM_ATOL, MLSTM_CLOSED_NOTE,
                     lambda shape: mlstm_bounds(shape, xcfg),
                     "kernel arithmetic", exact=in_f64(mlstm_ref))


def decoder_lm_paths(smi: str, moe_params: list | None = None) -> dict:
    """Phases 22-27: flash at the decoder-only LMs' heads, deepseek-moe-16b's
    prefill (its weights from ``moe_params``, a ``host_init`` box, if
    given), serve and timings, its f32 twin, and the other configs."""
    from repro_torch.configs import get_config
    mcfg = get_config(MOE_CONFIG)
    pcfg, qcfg = get_config("phi3-mini-3.8b"), get_config("qwen3-32b")
    m_expect = {"flash_attention": mcfg.num_layers}
    m_flash_rows = flash_check(mcfg, MOE_FLASH_SHAPES, SEED + 600)
    p_flash_rows = flash_check(pcfg, PHI3_FLASH_SHAPES, SEED + 650)
    q_flash_rows = flash_check(qcfg, QWEN3_FLASH_SHAPES, SEED + 700)
    mlm = prefill_path(mcfg, MOE_PREFILL_S, m_expect, limit=None,
                       params=moe_params)
    m_served = serve_path(mcfg, mlm, m_expect)
    print(f"[time] {mcfg.name}, {smi}:")
    m_times = lm_timings(mcfg, mlm, MOE_PREFILL_S)
    del mlm["model"], mlm["net"], mlm["batch"]
    torch.cuda.empty_cache()
    # The f32 twin: full width, the dense layer and two MoE layers, held at
    # every position and in the engine.
    mtcfg = dataclasses.replace(mcfg, name=f"{mcfg.name}-f32-twin",
                                num_layers=MOE_TWIN_LAYERS, dtype="float32",
                                param_dtype="float32")
    mt_expect = {"flash_attention": MOE_TWIN_LAYERS}
    mtlm = prefill_path(mtcfg, MOE_TWIN_S, mt_expect, limit=TWIN_ATOL,
                        every_position=True)
    m_twin = lm_record(mtlm, serve_path(mtcfg, mtlm, mt_expect,
                                        limit=TWIN_ATOL))
    del mtlm
    torch.cuda.empty_cache()
    config_runs = {}
    for name, seq, prefix in CONFIG_RUNS:
        ccfg = dataclasses.replace(get_config(name), num_layers=CONFIG_LAYERS)
        clm = prefill_path(ccfg, seq, {"flash_attention": CONFIG_LAYERS},
                           limit=None if ccfg.moe_num_experts
                           else PREFILL_ATOL, prefix=prefix)
        config_runs[name] = lm_record(clm)
        del clm
        torch.cuda.empty_cache()
    print(f"[time] flash at the decoder-only LMs' heads, {smi}:")
    flash_timings(m_flash_rows, mcfg, MOE_FLASH_SHAPES, SEED + 600)
    flash_timings(p_flash_rows, pcfg, PHI3_FLASH_SHAPES, SEED + 650)
    flash_timings(q_flash_rows, qcfg, QWEN3_FLASH_SHAPES, SEED + 700)
    return {"mcfg": mcfg, "pcfg": pcfg, "mlm": mlm, "m_served": m_served,
            "m_times": m_times, "m_twin": m_twin, "m_flash_rows": m_flash_rows,
            "p_flash_rows": p_flash_rows, "q_flash_rows": q_flash_rows,
            "config_runs": config_runs}


def encdec_serve_path(cfg, lm: dict, limit: float = PREFILL_ATOL) -> dict:
    """The encoder-decoder's serving path, which ``run_lockstep`` does not
    take (it never fills the cross cache, in JAX as in the port):
    SERVE_BATCH random clips through ``encode`` and ``fill_cross_cache``
    (one flash launch per encoder layer), then PROMPT_LEN prompt tokens and
    NEW_TOKENS greedy ones through ``decode_step`` (no launches), as
    tests/test_arch_smoke.py drives them; each first token equal to the
    argmax of the forward on the same prompts and clips wherever its
    margin exceeds ``limit``."""
    model, net = lm["model"], lm["net"]
    route = flash_route(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    frames = torch.randn(SERVE_BATCH, cfg.encoder_seq_len, cfg.d_model,
                         generator=g, device="cuda").to(
                             getattr(torch, cfg.dtype))
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT_LEN),
                            generator=g, device="cuda")
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    cache = model.fill_cross_cache(
        net, model.init_cache(SERVE_BATCH, PROMPT_LEN + NEW_TOKENS), frames)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    fill_launches = check_launches({"flash_attention": cfg.encoder_layers},
                                   f"{cfg.name} fill_cross_cache", route)
    zero_launches()
    t0 = time.perf_counter()
    for t in range(PROMPT_LEN):
        logits, cache = model.decode_step(net, cache, prompts[:, t:t + 1], t)
    nxt, outs = logits[:, -1].argmax(dim=-1), []
    for s_ in range(NEW_TOKENS):
        outs.append(nxt)
        logits, cache = model.decode_step(net, cache, nxt[:, None],
                                          PROMPT_LEN + s_)
        nxt = logits[:, -1].argmax(dim=-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check_launches({}, f"{cfg.name} decode steps")
    tokens = torch.stack(outs, dim=1)
    check(tokens.shape == (SERVE_BATCH, NEW_TOKENS) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
        "decoded token shape or range")
    expect = {"flash_attention": cfg.encoder_layers + 2 * cfg.num_layers}
    zero_launches()
    logits, _ = model.forward(net, {"tokens": prompts, "enc_frames": frames})
    torch.cuda.synchronize()
    launches = check_launches(expect, f"{cfg.name} cross-check forward",
                              route)
    ref_top, ref_margin = top2(logits[:, -1])
    del logits, cache
    first = tokens[:, 0]
    agree, n_sure = margin_agree(first, ref_top, ref_margin, limit)
    print(f"[serve] {cfg.name}: {SERVE_BATCH} clips of "
          f"{cfg.encoder_seq_len} frames through fill_cross_cache in "
          f"{fill_s:.2f} s (launches {fill_launches}), then {PROMPT_LEN} "
          f"prompt + {NEW_TOKENS} new tokens through decode_step in "
          f"{decode_s:.2f} s (no launches); first tokens {first.tolist()} vs "
          f"forward argmax {ref_top.tolist()} (margins "
          f"{[round(m, 3) for m in ref_margin.tolist()]}): equal at "
          f"{n_sure}/{SERVE_BATCH} clear positions: {agree}")
    check(agree, "decode's first token differs from the forward's argmax")
    return {"fill_cross_cache_s": fill_s, "fill_launches": fill_launches,
            "serve_wall_s": decode_s, "serve_launches": launches,
            "first_tokens": first.tolist(), "serve_positions_checked": n_sure,
            "outputs": tokens.tolist()}


def serve_example_path() -> dict:
    """``examples/serve_lm_torch.py`` on the card: gemma2-2b-smoke through
    ``run_lockstep``, its first tokens against the forward's argmax (the
    script raises on a difference), its forward's flash launches on the
    CUDA-core route (the smoke config is f32)."""
    import importlib.util

    from repro_torch.configs import get_config
    path = ROOT / "examples" / "serve_lm_torch.py"
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    layers = get_config("gemma2-2b-smoke").num_layers
    zero_launches()
    t0 = time.perf_counter()
    mod.main([])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = check_launches({"flash_attention": layers},
                              "examples/serve_lm_torch.py", "simt_f32")
    print(f"[example] examples/serve_lm_torch.py on the card in {secs:.1f} s"
          f": launches {launches}")
    return {"example_s": secs, "launches": launches}


def whisper_paths(smi: str) -> dict:
    """Phases 28-33: flash at whisper-large-v3's heads, its bf16 forward at
    full width and depth on 4 clips, its serving, timings, the f32 forward
    at full depth, and ``examples/serve_lm_torch.py``."""
    from repro_torch.configs import get_config
    wcfg = get_config(WHISPER_CONFIG)
    w_expect = {"flash_attention": wcfg.encoder_layers + 2 * wcfg.num_layers}
    w_flash_rows = flash_check(wcfg, WHISPER_FLASH_SHAPES, SEED + 800)
    wlm = prefill_path(wcfg, WHISPER_TOKENS, w_expect, rows=WHISPER_ROWS)
    w_served = encdec_serve_path(wcfg, wlm)
    print(f"[time] {wcfg.name}, {smi}:")
    w_times = lm_timings(wcfg, wlm, WHISPER_TOKENS)
    del wlm["model"], wlm["net"], wlm["batch"]
    torch.cuda.empty_cache()
    # The same forward in f32 at full depth on one clip, held at every
    # position, and its serving, held where the margin exceeds TWIN_ATOL
    # (in bf16 the random logits' top-2 margins rarely exceed 0.25, so the
    # bf16 serve check may hold no position): these carry the path's
    # correctness.
    w32cfg = dataclasses.replace(wcfg, name=f"{wcfg.name}-f32",
                                 dtype="float32", param_dtype="float32")
    w32lm = prefill_path(w32cfg, WHISPER_TOKENS, w_expect, limit=TWIN_ATOL,
                         every_position=True)
    w32 = lm_record(w32lm, encdec_serve_path(w32cfg, w32lm,
                                             limit=TWIN_ATOL))
    del w32lm
    torch.cuda.empty_cache()
    example = serve_example_path()
    print(f"[time] flash at {wcfg.name}'s heads, {smi}:")
    flash_timings(w_flash_rows, wcfg, WHISPER_FLASH_SHAPES, SEED + 800)
    check(sum(r["per_forward"] for r in w_flash_rows)
          == w_expect["flash_attention"],
          "WHISPER_FLASH_SHAPES do not add up to one forward")
    return {"wcfg": wcfg, "w32cfg": w32cfg, "wlm": wlm, "w_served": w_served,
            "w_times": w_times, "w32": w32, "w_flash_rows": w_flash_rows,
            "example": example}

# --- minicpm-2b training (phases 34-38) --------------------------------------

TRAIN_CONFIG = "minicpm-2b"
# What the names of flash's device kernels contain: the forward's
# (flash_attention_sm90_kernel, flash_attention_fwd_kernel) and the
# backward's (flash_bwd_*, every route).
FLASH_MARKS = {"flash forward": ("flash_attention",),
               "flash backward": ("flash_bwd_",)}
TRAIN_ROWS, TRAIN_SEQ = 4, 1024
TRAIN_STEPS = 3           # through make_train_step; then one more with remat
TRAIN_LR = 3e-4
# WSD with a 2-step warmup: lr 0.5, 1, 1, 1 × 3e-4 at steps 1-4, so that an
# update moves a bf16 weight (the default 100-step warmup's 3e-6 would not)
TRAIN_WARMUP, TRAIN_TOTAL = 2, 1000
TRAIN_TWIN_LAYERS = 2
TRAIN_LOSS_RTOL = 1e-5    # the twin's loss, kernel path vs ops.plain()
TRAIN_GRAD_RTOL = 1e-4    # per gradient leaf, of max|g_plain|
GRAD_F32_RTOL = 1e-5      # flash gradient, f32: of max|ref|
# A bf16 weight keeps its bits when its update is under half an ulp below
# it: 2^-9 of |p| (the spacing below a power of two is 2^-8 of it).
BF16_HALF_ULP = 2.0**-9
# The flash gradient against autograd of the plain attention in f32, each
# shape in bf16 (the tensor-core backward) and in f32 (the CUDA-core one):
# name, B, H, KV, S, T, D, causal, window, softcap.
GRAD_SHAPES = [
    ("minicpm_4x1024", 4, 36, 36, 1024, 1024, 64, True, 0, 0.0),
    ("qwen3_gqa64to8_S512", 1, 64, 8, 512, 512, 128, True, 0, 0.0),
    ("gemma2_D256_win128_cap50", 1, 8, 4, 512, 512, 256, True, 128, 50.0),
    ("zamba2_D80_4x1024", 4, 32, 32, 1024, 1024, 80, True, 0, 0.0),
    ("whisper_cross_S448_T1500", 4, 20, 20, 448, 1500, 64, False, 0, 0.0),
]
# gemma2-2b's training shapes (phase 53's layers: 1x8192, 8 query and 4 KV
# heads of 256, softcap 50; the global layers causal, the local ones with
# the 4096 window, which bites past position 4096), held in bf16 only in
# phase 34 and timed by --flash-bwd-times.
GEMMA2_GRAD_SHAPES = [
    ("gemma2_train_1x8192_global", 1, 8, 4, 8192, 8192, 256, True, 0, 50.0),
    ("gemma2_train_1x8192_win4096", 1, 8, 4, 8192, 8192, 256, True, 4096,
     50.0),
]
# paligemma-3b's heads (8 query heads and 1 KV head of 256, no softcap):
# SDPA's backward (is_causal, enable_gqa) computes the same function there,
# so --flash-bwd-times times it beside the D = 256 kernel.
PALIGEMMA_GRAD_SHAPE = ("paligemma_4x1024", 4, 8, 1, 1024, 1024, 256, True,
                        0, 0.0)
# examples/train_lm_torch.py's default run, and where the failure goes.
RESTART_STEPS, RESTART_FAIL_AT = 30, 12
# gemma2-2b's training (phases 53-55) at Gemma 2's training context
# (arXiv:2408.00118), where the local layers' 4096 window bites; every step
# with remat: the plain step needs more than the card's 80 GB.  Its f32 twin
# takes one local and one global layer at a length past the window.
GEMMA2_TRAIN_CONFIG = "gemma2-2b"
GEMMA2_TRAIN_ROWS, GEMMA2_TRAIN_SEQ = 1, 8192
GEMMA2_TWIN_LAYERS, GEMMA2_TWIN_SEQ = 2, 4608


def flash_grad_check(seed: int) -> list[dict]:
    """Phase 34: dq, dk and dv through ``ops.flash_attention`` (the kernel
    inside the ``FlashAttention`` autograd function, whose backward launches
    the backward kernel of the dtype's route) against autograd of the plain
    attention in f32 on the same values, at every shape of GRAD_SHAPES in
    bf16 and in f32 and at GEMMA2_GRAD_SHAPES in bf16.  Each shape runs
    twice: the two gradients bit-equal, two forward and two backward
    launches, each on its dtype's route, and no call of the plain
    gradient."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import backward_route
    print(f"[grad] limits, per element against autograd of the plain "
          f"attention in f32 on the same values: f32 |got - ref| <= "
          f"{GRAD_F32_RTOL}*max|ref|; bf16 |got - ref| <= "
          f"{FLASH_RTOL[torch.bfloat16]}*|ref| + {FLASH_ATOL} (half a bf16 "
          f"ulp)")
    rows = []
    cases = ([(shape, (torch.bfloat16, torch.float32))
              for shape in GRAD_SHAPES]
             + [(shape, (torch.bfloat16,)) for shape in GEMMA2_GRAD_SHAPES])
    for i, ((name, B, H, KV, S, T, D, causal, window,
             softcap), dtypes) in enumerate(cases):
        for dtype in dtypes:
            tag = f"{name}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
            g = torch.Generator(device="cuda").manual_seed(seed + i)
            q, k, v = (torch.randn(B, n, heads, D, generator=g,
                                   device="cuda").to(dtype)
                       for n, heads in ((S, H), (T, KV), (T, KV)))
            do = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
            kw = dict(causal=causal, window=window, softcap=softcap)
            route = "wgmma_bf16" if dtype == torch.bfloat16 else "simt_f32"
            bwd_route = backward_route(dtype, D)
            zero_launches()
            runs = []
            for _ in range(2):
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                ops.flash_attention(*leaves, **kw).backward(do)
                runs.append([t.grad for t in leaves])
            torch.cuda.synchronize()
            check_launches(train_expect(2), f"{tag}: two forwards and "
                           f"backwards", route, bwd_route)
            same = all(torch.equal(a, b) for a, b in zip(*runs))
            check(same, f"{tag}: two backward launches differ")
            refs = [t.float().requires_grad_() for t in (q, k, v)]
            with ops.plain():
                ops.flash_attention(*refs, **kw).backward(do.float())
            errs, used = [], 0.0
            for t, r in zip(runs[0], refs):
                check(t.dtype == dtype and t.shape == r.grad.shape
                      and t.is_contiguous(),
                      f"{tag}: gradient {t.dtype} {tuple(t.shape)}")
                err = (t.float() - r.grad).abs()
                errs.append(err.max().item())
                lim = (GRAD_F32_RTOL * r.grad.abs().max() if dtype ==
                       torch.float32 else FLASH_RTOL[dtype] * r.grad.abs()
                       + FLASH_ATOL)
                used = max(used, (err / lim).max().item())
            print(f"[grad] {tag:33s} {route} + {bwd_route}: "
                  f"max_abs_err dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
                  f"{errs[2]:.3e}; limit used {used:.3f}; two backward "
                  f"launches bit-equal {same}")
            check(used <= 1.0, f"{tag}: flash gradient vs plain exceeds its "
                  f"limit {used:.3f}-fold")
            rows.append({"name": tag, "route": route,
                         "backward_route": bwd_route, "B": B,
                         "H": H, "KV": KV, "S": S, "T": T, "D": D,
                         "causal": causal, "window": window,
                         "softcap": softcap, "max_abs_err": max(errs),
                         "limit_used": used, "bit_equal": same})
            del q, k, v, do, leaves, refs, runs
    torch.cuda.empty_cache()
    return rows


def train_setup(cfg):
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainStepConfig
    ts = TrainStepConfig(opt=AdamWConfig(lr=TRAIN_LR),
                         schedule_warmup=TRAIN_WARMUP,
                         schedule_total_steps=TRAIN_TOTAL)
    return build_model(cfg), ts


def below_half_ulp(state: dict, ts, lr: float, i: int) -> bool:
    """Whether leaf ``i``'s last AdamW update, recomputed from the moments
    the step left, is under half a bf16 ulp of every weight: then the bf16
    weight keeps its bits although the update ran."""
    from repro_torch import tree
    step = state["opt"]["step"].float()
    b1t, b2t = 1 - ts.opt.b1 ** step, 1 - ts.opt.b2 ** step
    p = tree.leaves(state["params"])[i].detach().float()
    m = tree.leaves(state["opt"]["m"])[i]
    v = tree.leaves(state["opt"]["v"])[i]
    delta = (m / b1t) / ((v / b2t).sqrt() + ts.opt.eps) \
        + ts.opt.weight_decay * p
    return bool(m.abs().max() > 0) and bool(
        (lr * delta.abs() < BF16_HALF_ULP * p.abs()).all())


def step_launches(expect: dict[str, int], remat: bool) -> dict[str, int]:
    """A train step's launches from ``expect``, one forward's and one
    backward's: with remat every forward kernel runs again in the
    backward."""
    return {k: n * (2 if remat and not k.endswith("_bwd") else 1)
            for k, n in expect.items()}


def train_path(smi: str, cfg, rows: int, seq: int, expect: dict[str, int],
               remat: bool = False, n_steps: int = TRAIN_STEPS,
               params: dict | None = None) -> dict:
    """Phases 35, 41, 44 and 53: ``cfg`` at full width and depth in bf16
    takes ``n_steps`` steps of ``make_train_step`` at ``rows`` x ``seq``
    and one more with remat (with ``remat``, for a config whose plain step
    does not fit on the card, every step and the gradient take it): each
    step exactly ``expect`` launches of each kernel (``step_launches``),
    flash on its dtype's route; loss and grad_norm finite; every leaf
    changes, or its last update was under half a bf16 ulp of every weight;
    every leaf gets a gradient of nonzero finite norm.  ``params``, a tree
    of host tensors with the values ``model.init`` draws from SEED (an
    earlier phase's, copied off the card), takes the place of the draw."""
    from repro_torch import tree
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.models.api import param_count
    from repro_torch.train.trainer import (init_train_state, make_grad_fn,
                                           make_train_step)
    model, ts = train_setup(cfg)
    ts = dataclasses.replace(ts, remat=remat)
    route = flash_route(cfg) if expect.get("flash_attention") else None
    t0 = time.perf_counter()
    if params is None:
        lm, drawn = model.init(seed=SEED), "init from seed"
        before = [p.detach().to("cpu", copy=True)
                  for p in tree.leaves(lm.params)]
    else:
        lm, drawn = model.bind(params), "an earlier phase's draw from seed"
        before = tree.leaves(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(lm.params)
    state = init_train_state(model, lm, ts)
    check(all(a is b for a, b in zip(tree.leaves(model.bind(
        state["params"]).params), tree.leaves(lm.params))),
        "the train state does not hold the model's own tensors")
    print(f"[train] {cfg.name} ({cfg.family}): {cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.num_heads} heads, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype}: {n_params} parameters; {drawn} {SEED} "
          f"in {init_s:.1f} s; AdamW lr {TRAIN_LR}, {cfg.lr_schedule} "
          f"schedule (warmup {TRAIN_WARMUP}, total {TRAIN_TOTAL}); batch "
          f"{rows}x{seq} from batch_for_step; launches a forward and "
          f"backward {expect}"
          + ("; every step with remat: the plain step does not fit in the "
             "card's memory" if remat else ""))
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for s in range(n_steps + 1):
        step_remat = ts.remat or s == n_steps
        step_fn = make_train_step(model, dataclasses.replace(
            ts, remat=step_remat))
        batch = batch_for_step(cfg, s, rows, seq)
        torch.cuda.synchronize()
        if s == n_steps:
            plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = check_launches(step_launches(expect, step_remat),
                                  f"{cfg.name} train step {s}", route)
        row = {"step": s, "remat": step_remat, "s": secs,
               "launches": {k: n for k, n in launches.items() if n},
               **{k: float(metrics[k]) for k in ("loss", "aux_loss",
                                                  "grad_norm", "lr")}}
        print(f"[train] step {s}{' (remat)' if step_remat else ''}: loss "
              f"{row['loss']:.4f}, grad_norm {row['grad_norm']:.4f}, lr "
              f"{row['lr']:.3e}, {secs * 1e3:.1f} ms (host clock, first "
              f"calls included), launches {row['launches']}"
              + (f" flash on {route}" if route else ""))
        check(math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"]),
              f"step {s}: loss or grad_norm not finite")
        steps.append(row)
    remat_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[train] peak device memory (torch.cuda.max_memory_allocated): "
          f"{plain_peak_gb:.2f} GB over steps 0-{n_steps - 1}"
          f"{' (remat)' if ts.remat else ''}, {remat_peak_gb:.2f} GB in the "
          f"remat step")
    moved, kept = 0, []
    names = list(leaf_names(state["params"]))
    for i, (old, new) in enumerate(zip(before, tree.leaves(state["params"]))):
        if torch.equal(old, new.detach().cpu()):
            kept.append(names[i])
            check(below_half_ulp(state, ts, steps[-1]["lr"], i),
                  f"{names[i]} kept its bits but its update was not below "
                  f"half a bf16 ulp")
        else:
            moved += 1
    del before
    print(f"[train] leaves changed: {moved} of {moved + len(kept)}; kept "
          f"their bf16 bits (every update under half an ulp, recomputed "
          f"from the moments, which are nonzero): {kept}")
    zero_launches()
    loss, _, grads = make_grad_fn(model, ts)(state["params"], batch)
    torch.cuda.synchronize()
    check_launches(step_launches(expect, ts.remat), f"{cfg.name} gradient",
                   route)
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32).item()
             for g in tree.leaves(grads)]
    del grads
    check(all(math.isfinite(n) and n > 0 for n in norms),
          "a leaf has a zero or non-finite gradient")
    low = min(range(len(norms)), key=norms.__getitem__)
    print(f"[train] every one of {len(norms)} leaves has a nonzero finite "
          f"gradient; the smallest norm {norms[low]:.3e} ({names[low]})")
    torch.cuda.empty_cache()
    return {"cfg": cfg, "model": model, "ts": ts, "state": state,
            "batch": batch, "params": n_params, "rows": rows, "seq": seq,
            "record": {"init_s": init_s, "params": n_params,
                       "steps": steps, "peak_gb": plain_peak_gb,
                       "remat_peak_gb": remat_peak_gb,
                       "leaves_changed": moved, "leaves_kept": kept,
                       "grad_norm_min": norms[low]}}


def leaf_names(params: dict, prefix: str = ""):
    """The leaf paths of ``params``, in leaf order."""
    for k in sorted(params):
        if isinstance(params[k], dict):
            yield from leaf_names(params[k], f"{prefix}{k}/")
        else:
            yield prefix + k


def train_timings(tp: dict, smi: str, marks: dict[str, tuple[str, ...]],
                  profile_tp: dict | None = None) -> dict:
    """Phases 38, 43, 45 and 54, printed and not held: the step's time,
    tokens/s and its share of the 6·N·tokens FLOPs at 989 TFLOP/s;
    forward, backward and optimizer apart (one of each);
    one step under torch.profiler (the top kernels, the share of device
    time of each kernel named by ``marks`` (label -> substrings of device
    kernel names), the idle share), of ``profile_tp``'s model where
    given."""
    from repro_torch import tree
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.optim.schedule import make_schedule
    from repro_torch.train.trainer import cross_entropy, make_train_step
    cfg, model, ts, state, batch = (tp[k] for k in ("cfg", "model", "ts",
                                                    "state", "batch"))

    def loss_fn(params):
        logits, aux = model.forward(model.bind(params), batch,
                                    remat=ts.remat)
        return cross_entropy(logits, batch["labels"]) + aux
    step_fn = make_train_step(model, ts)
    tokens = tp["rows"] * tp["seq"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    remat_fn = make_train_step(model, dataclasses.replace(ts, remat=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = remat_fn(state, batch)
    torch.cuda.synchronize()
    remat_ms = (time.perf_counter() - t0) * 1e3
    model_flops = 6 * tp["params"] * tokens
    mfu = model_flops / (step_ms / 1e3) / PEAK_BF16_OPS
    schedule = make_schedule(cfg.lr_schedule, warmup=ts.schedule_warmup,
                             total=ts.schedule_total_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = loss_fn(state["params"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    leaves = tree.leaves(state["params"])
    grads = tree.unflatten(state["params"], list(
        torch.autograd.grad(loss, leaves)))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    state["params"], state["opt"], _ = adamw_update(
        ts.opt, state["params"], grads, state["opt"],
        schedule(state["opt"]["step"] + 1))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del loss, grads
    parts_ms = {"forward": (t1 - t0) * 1e3, "backward": (t2 - t1) * 1e3,
                "optimizer": (t3 - t2) * 1e3}
    # AdamW must read p and g (bf16) and m and v (f32) and write p, m, v:
    # 22 bytes a parameter
    opt_bound_ms = 22 * tp["params"] / PEAK_BYTES * 1e3
    print(f"[time] {cfg.name} train step {tp['rows']}x{tp['seq']}, {smi}: "
          f"{step_ms:.1f} ms (host clock around a synchronised step), "
          f"{tokens / step_ms * 1e3:.0f} tokens/s; 6*N*tokens = "
          f"{model_flops:.3e} FLOP, {mfu:.4f} of {PEAK_BF16_OPS / 1e12:.0f} "
          f"TFLOP/s; forward {parts_ms['forward']:.1f} ms, backward "
          f"{parts_ms['backward']:.1f} ms, optimizer "
          f"{parts_ms['optimizer']:.1f} ms (one each; its bound "
          f"{opt_bound_ms:.1f} ms, 22 bytes a parameter); with remat "
          f"{remat_ms:.1f} ms (one step, after its first call)"
          + (" (every step here takes remat)" if ts.remat else ""))
    tp["state"] = state
    prof_ = profile_step(profile_tp or tp, marks)
    return {"step_ms": step_ms, "remat_step_ms": remat_ms,
            "optimizer_bound_ms": opt_bound_ms,
            "tokens_per_s": tokens / step_ms * 1e3,
            "model_flops": model_flops, "mfu": mfu, "parts_ms": parts_ms,
            "profile": prof_}


def profile_step(tp: dict, marks: dict[str, tuple[str, ...]]) -> dict | None:
    """One train step of ``tp``'s model under torch.profiler: the top
    kernels, the idle share and each of ``marks``' share of device time
    (flash's backward kernels among them, by name)."""
    from torch.profiler import ProfilerActivity, record_function

    from repro_torch.train.trainer import make_train_step
    cfg, state, batch = tp["cfg"], tp["state"], tp["batch"]
    step_fn = make_train_step(tp["model"], tp["ts"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with record_function("train_step"):
            state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
    tp["state"] = state
    events = prof.events()
    print(f"[profile] {cfg.name} ({cfg.num_layers} layers) train step: "
          f"{len(events)} events recorded and read in "
          f"{time.perf_counter() - t0:.1f} s")
    prof_ = device_breakdown(events, "train_step", 1)
    if prof_ is None:
        print("[profile] the profiler recorded no device time: not measured")
        return None
    busy = prof_["device_busy_us"]
    shares = {}
    for label, names in marks.items():
        us = sum(k["us"] for k in prof_["all_kernels"]
                 if any(n in k["name"] for n in names))
        shares[label] = {"us": us, "share_of_busy": us / busy}
    prof_["shares"] = shares
    del prof_["all_kernels"], events, prof
    print(f"[profile] train step, of {busy / 1e3:.1f} ms device busy: "
          + "; ".join(f"{k} {v['us'] / 1e3:.2f} ms ({v['share_of_busy']:.3f})"
                      for k, v in shares.items())
          + f"; idle share {prof_['idle_share']:.3f}")
    return prof_


def attention_timings(tp: dict, smi: str) -> dict:
    """Phase 38's yardstick: the attention at one layer's shape of ``tp``'s
    model: the forward kernel, the autograd function's forward and
    backward, the backward kernels alone against their bound, the plain
    backward (``ref.attention_ref_grad``, timed as the yardstick it
    replaced), the plain forward and backward, and SDPA's forward +
    backward and backward alone with ``is_causal`` (a yardstick the port
    never calls; the same function, as minicpm has no softcap)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    plain_grad = getattr(ref.attention_ref_grad, "plain",
                         ref.attention_ref_grad)
    cfg = tp["cfg"]
    rows, seq = tp["rows"], tp["seq"]
    H, D = cfg.num_heads, cfg.resolved_head_dim
    g = torch.Generator(device="cuda").manual_seed(SEED + 950)
    q, k, v, do = (torch.randn(rows, seq, H, D, generator=g,
                               device="cuda").bfloat16() for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    q3, k3, v3, do3 = (t.transpose(1, 2).reshape(-1, seq, D)
                       .contiguous() for t in (q, k, v, do))
    q4, k4, v4 = (t.transpose(1, 2).detach().clone().requires_grad_()
                  for t in (q, k, v))
    do4 = do.transpose(1, 2).contiguous()
    out3, lse, lo = FA.flash_attention_kernel(q3, k3, v3, stats=True)
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    def fwd_bwd():
        ops.flash_attention(*leaves).backward(do)

    def plain_fwd_bwd():
        with ops.plain():
            ops.flash_attention(*leaves).backward(do)

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: ops.flash_attention(q, k, v), iters=10)
    att = {"forward_ms": fwd_ms,
           "fwd_bwd_ms": cuda_ms(fwd_bwd, iters=10),
           "backward_kernel_ms": cuda_ms(
               lambda: FA.flash_attention_backward_kernel(
                   q3, k3, v3, out3, lse, do3, out_lo=lo), iters=20),
           "backward_ms": cuda_ms(lambda: plain_grad(
               q3, k3, v3, do3, causal=True), iters=3, warmup=1),
           "plain_fwd_bwd_ms": cuda_ms(plain_fwd_bwd, iters=3, warmup=1),
           "library_fwd_bwd_ms": cuda_ms(
               lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, is_causal=True).backward(do4), iters=10),
           "library_backward_ms": cuda_ms(
               lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                           retain_graph=True), iters=10)}
    bh = rows * H
    pairs = flash_pairs(seq, seq, True, 0)
    # forward 2 products (4·D per visible pair), backward 5 (S again, dP,
    # dV, dQ, dK: 10·D); q, k, v, dO read, O, dQ, dK, dV written, bf16
    att.update(roofline(14 * D * bh * pairs, 2 * D * bh * seq * 8,
                        PEAK_BF16_OPS))
    # the backward alone: 10·D a pair; q, k, v, O, dO and the f32 lse read,
    # dq, dk, dv written
    bwd = roofline(10 * D * bh * pairs, 16 * D * bh * seq + 4 * bh * seq,
                   PEAK_BF16_OPS)
    att.update({"backward_bound_ms": bwd["bound_ms"],
                "backward_bound_by": bwd["bound_by"],
                "backward_ops": bwd["ops"], "backward_bytes": bwd["bytes"],
                # as built: S and dP once, P and dS as hi + lo (16·D)
                "backward_built_ops_ms": 1.6 * bwd["ops_ms"]})
    print(f"[time] attention at one layer's shape ({rows}x{seq}, "
          f"{H} heads of {D}, causal, bf16), {smi}: flash forward kernel "
          f"{att['forward_ms']:.4f} ms; forward + backward through the "
          f"autograd function {att['fwd_bwd_ms']:.4f} ms; the backward "
          f"kernels alone {att['backward_kernel_ms']:.4f} ms (bound "
          f"{att['backward_bound_ms']:.4f}, {att['backward_bound_by']}, 10*D "
          f"a pair; {att['backward_built_ops_ms']:.4f} at the 16*D it does; "
          f"{att['backward_ops'] / att['backward_kernel_ms'] / 1e9:.1f} "
          f"TFLOP/s of the 10*D); the plain f32 backward it replaced "
          f"{att['backward_ms']:.4f}; plain forward + backward "
          f"{att['plain_fwd_bwd_ms']:.4f}; SDPA forward + backward "
          f"(is_causal) {att['library_fwd_bwd_ms']:.4f}, its backward alone "
          f"{att['library_backward_ms']:.4f}; forward + backward bound "
          f"{att['bound_ms']:.4f} ({att['bound_by']}); x{cfg.num_layers} per "
          f"step: {att['fwd_bwd_ms'] * cfg.num_layers:.1f} ms against SDPA's "
          f"{att['library_fwd_bwd_ms'] * cfg.num_layers:.1f}")
    del q, k, v, do, leaves, q3, k3, v3, do3, q4, k4, v4, do4, out3, out4
    return att


def f32_backward_timings(smi: str) -> dict:
    """The CUDA-core backward at the minicpm-2b f32 twin's layer shape
    (4x1024, 36 heads of 64, causal): the backward kernels against their
    bound (10·D a pair at 67 TFLOP/s), the plain backward and SDPA's f32
    backward (TF32 off)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    plain_grad = getattr(ref.attention_ref_grad, "plain",
                         ref.attention_ref_grad)
    cfg = get_config(TRAIN_CONFIG)
    H, D = cfg.num_heads, cfg.resolved_head_dim
    bh, seq = TRAIN_ROWS * H, TRAIN_SEQ
    g = torch.Generator(device="cuda").manual_seed(SEED + 960)
    q, k, v, do = (torch.randn(bh, seq, D, generator=g, device="cuda")
                   for _ in range(4))
    out, lse, _ = FA.flash_attention_kernel(q, k, v, stats=True)
    q4, k4, v4 = (t.view(TRAIN_ROWS, H, seq, D).clone().requires_grad_()
                  for t in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.view(TRAIN_ROWS, H, seq, D)
    pairs = flash_pairs(seq, seq, True, 0)
    bwd = roofline(10 * D * bh * pairs, 32 * D * bh * seq + 4 * bh * seq,
                   PEAK_F32_OPS)
    att = {"ms": cuda_ms(lambda: FA.flash_attention_backward_kernel(
               q, k, v, out, lse, do), iters=10),
           "plain_ms": cuda_ms(lambda: plain_grad(q, k, v, do, causal=True),
                               iters=3, warmup=1),
           "library_ms": cuda_ms(lambda: torch.autograd.grad(
               out4, (q4, k4, v4), do4, retain_graph=True), iters=10),
           "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
           "ops": bwd["ops"]}
    print(f"[time] the f32 backward kernels at one {cfg.name} f32 twin "
          f"layer ({TRAIN_ROWS}x{seq}, {H} heads of {D}, causal), {smi}: "
          f"{att['ms']:.4f} ms (bound {att['bound_ms']:.4f}, "
          f"{att['bound_by']}, 10*D a pair at 67 TFLOP/s; "
          f"{att['ops'] / att['ms'] / 1e9:.1f} TFLOP/s); the plain f32 "
          f"backward {att['plain_ms']:.4f}; SDPA's backward alone in f32 "
          f"(is_causal, TF32 off) {att['library_ms']:.4f}")
    del q, k, v, do, out, lse, q4, k4, v4, out4, do4
    return att


def train_twin_path(name: str, layers: int, rows: int, seq: int,
                    expect: dict[str, int]) -> dict:
    """Phases 36, 42 and 44: ``name`` at full width cut to ``layers``
    layers, in f32 (flash on the CUDA-core route): one gradient and one
    train step at ``rows`` x ``seq`` through the kernel path (``expect``
    launches) and the same under ``ops.plain()`` (none) from the same
    state: the loss within TRAIN_LOSS_RTOL relative, every gradient leaf
    within TRAIN_GRAD_RTOL·max|g_plain|, the new parameters within 2·lr +
    1e-6 (JAX's bound for an AdamW step whose gradient flips sign), and
    every leaf changed.  This carries the training path's correctness."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import (init_train_state, make_grad_fn,
                                           make_train_step)
    cfg = dataclasses.replace(get_config(name), name=f"{name}-f32-twin",
                              num_layers=layers, dtype="float32",
                              param_dtype="float32")
    model, ts = train_setup(cfg)
    kern, plain = (init_train_state(model, model.init(seed=SEED), ts)
                   for _ in range(2))
    check(all(torch.equal(a, b) for a, b in zip(tree.leaves(kern),
                                                tree.leaves(plain))),
          "two inits from one seed differ")
    before = [p.detach().clone() for p in tree.leaves(kern["params"])]
    batch = batch_for_step(cfg, 0, rows, seq)
    grad_fn, step_fn = make_grad_fn(model, ts), make_train_step(model, ts)
    route = flash_route(cfg) if expect.get("flash_attention") else None
    zero_launches()
    lk, _, gk = grad_fn(kern["params"], batch)
    torch.cuda.synchronize()
    check_launches(expect, f"{cfg.name} gradient", route)
    with ops.plain():
        lp, _, gp = grad_fn(plain["params"], batch)
    check_launches(expect, f"{cfg.name} plain gradient", route)
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    grad_used = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(tree.leaves(gk), tree.leaves(gp))) \
        / TRAIN_GRAD_RTOL
    del gk, gp
    zero_launches()
    kern, mk = step_fn(kern, batch)
    torch.cuda.synchronize()
    launches = check_launches(expect, f"{cfg.name} train step", route)
    with ops.plain():
        plain, mp = step_fn(plain, batch)
    lr = float(mk["lr"])
    param_err = max((a - b).abs().max().item() for a, b in zip(
        tree.leaves(kern["params"]), tree.leaves(plain["params"])))
    changed = sum(not torch.equal(a, b.detach()) for a, b in zip(
        before, tree.leaves(kern["params"])))
    print(f"[train] {cfg.name} ({layers} layers at full width, f32, "
          f"{rows}x{seq}) kernel path vs ops.plain(): loss "
          f"{lk.item():.6f} vs {lp.item():.6f} (rel {loss_rel:.2e}, limit "
          f"{TRAIN_LOSS_RTOL}); gradients limit used {grad_used:.3f} (per "
          f"leaf, of {TRAIN_GRAD_RTOL}*max|g_plain|); step loss "
          f"{float(mk['loss']):.6f} vs {float(mp['loss']):.6f}, grad_norm "
          f"{float(mk['grad_norm']):.6f} vs {float(mp['grad_norm']):.6f}; "
          f"new parameters max_abs_err {param_err:.3e} (limit 2*lr + 1e-6 = "
          f"{2 * lr + 1e-6:.3e}); leaves changed {changed} of {len(before)}")
    check(loss_rel <= TRAIN_LOSS_RTOL, "twin loss differs from plain")
    check(grad_used <= 1.0, "twin gradients differ from plain")
    check(param_err <= 2 * lr + 1e-6, "twin update differs from plain")
    check(changed == len(before), "a twin leaf did not change")
    del kern, plain
    torch.cuda.empty_cache()
    return {"loss_rel_err": loss_rel, "grad_limit_used": grad_used,
            "param_max_abs_err": param_err, "lr": lr,
            "leaves_changed": changed, "launches": launches}


def restart_path() -> dict:
    """Phase 37: ``examples/train_lm_torch.py``'s default run (lm-10m,
    f32, 30 steps of 8x128, a checkpoint every 10) on the card, once
    uninterrupted and once with a ``TransientError`` injected at step 12:
    the second restores step 10's checkpoint and replays, and its per-step
    losses (the replayed step 11 too) and final state equal the first's bit
    for bit; the loss falls; flash launches once a layer a step (f32, the
    CUDA-core route)."""
    import importlib.util
    import tempfile

    from repro_torch import tree
    from repro_torch.train.fault_tolerance import TransientError
    path = ROOT / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    layers = mod.model_config(False).num_layers
    tripped = {}

    def injector(step):
        if step == RESTART_FAIL_AT and not tripped:
            tripped["at"] = step
            raise TransientError(f"simulated node loss at step {step}")

    runs = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        for name, inject in (("clean", None), ("restarted", injector)):
            args = mod.parser().parse_args(
                ["--steps", str(RESTART_STEPS), "--ckpt-dir", f"{d}/{name}"])
            zero_launches()
            t0 = time.perf_counter()
            runs[name] = mod.train(args, fail_injector=inject)
            torch.cuda.synchronize()
            runs[name]["s"] = time.perf_counter() - t0
            runs[name]["launches"] = check_launches(
                train_expect(layers * len(runs[name]["history"])),
                f"train_lm_torch {name}", "simt_f32")
    clean, again = runs["clean"], runs["restarted"]
    by_step: dict[int, list[float]] = {}
    for step, loss in again["history"]:
        by_step.setdefault(step, []).append(loss)
    twice = sorted(s for s, ls in by_step.items() if len(ls) > 1)
    replays_equal = all(len(set(ls)) == 1 for ls in by_step.values())
    same_state = all(torch.equal(a.detach(), b.detach()) for a, b in zip(
        tree.leaves(clean["state"]), tree.leaves(again["state"])))
    losses = clean["losses"]
    print(f"[restart] examples/train_lm_torch.py, {RESTART_STEPS} steps, "
          f"TransientError at step {RESTART_FAIL_AT}: restarts "
          f"{again['report'].restarts}, steps run {len(again['history'])} "
          f"(replayed {twice}), launches clean {clean['launches']} restarted "
          f"{again['launches']}; per-step losses equal the uninterrupted "
          f"run's bit for bit: {again['losses'] == losses}; replayed steps "
          f"equal their first run: {replays_equal}; final state "
          f"bit-equal: {same_state}; loss {losses[0]:.4f} -> "
          f"{losses[RESTART_STEPS - 1]:.4f}; {clean['s']:.1f} s and "
          f"{again['s']:.1f} s")
    check(again["report"].restarts == 1 and tripped, "no restart happened")
    check(bool(twice) and replays_equal and again["losses"] == losses,
          "the restarted run's losses differ from the uninterrupted run's")
    check(same_state, "the restarted run's final state differs")
    check(losses[RESTART_STEPS - 1] < losses[0], "the loss did not fall")
    return {"losses": [losses[s] for s in sorted(losses)],
            "replayed": twice, "clean_s": clean["s"],
            "restarted_s": again["s"], "launches": clean["launches"]}


# --- zamba2-2.7b and xlstm-1.3b training: the scans' backward kernels -----------

HYBRID_TRAIN_ROWS, HYBRID_TRAIN_SEQ = 4, 1024
XLSTM_TRAIN_ROWS, XLSTM_TRAIN_SEQ = 4, 512
# xlstm-1.3b's steps before the remat step: each step is seconds of the
# sLSTM's host loop (PERF.md §5), so one keeps the script within its limit
# on a slower host.
XLSTM_TRAIN_STEPS = 1
# xlstm-1.3b's training depth: two of its twelve units at full width (each
# unit's sLSTM loops over the 512 steps on the host, so the step's time
# grows with the depth); every other check of the path stays.
XLSTM_TRAIN_LAYERS = 8
HYBRID_TWIN_LAYERS = 6     # one unit: five Mamba2 layers and an attention
XLSTM_TWIN_LAYERS = 4      # one unit: three mLSTM layers and an sLSTM
# The twins' rows: under ops.plain() autograd keeps every step's state of
# each scan layer, 10.7 GB a Mamba2 layer at 4x1024 (80 heads of 64 x 64,
# two a step) and ~25 GB an mLSTM layer at 4x512 (4 heads of 512 x 512).
HYBRID_TWIN_ROWS, XLSTM_TWIN_ROWS = 2, 1
SCAN_GRAD_RTOL = 1e-4      # per gradient tensor, of max|g_plain|
# max|g_plain| is taken as at least GRAD_ZERO of the shape's largest
# gradient: at forget-all i_t sets m_t and cancels, and the plain f32
# gradient of i_pre is rounding (~1e-10, 73% off the f64 gradient in
# tests/test_torch_mlstm_scan.py's emulation); at the full reset d a_log is
# ~1e-12.
GRAD_ZERO = 1e-6
# The backward kernels against autograd of the plain recurrence in f32:
# name, launches per train step, b, S, and a_log (None: -softplus(N(0, 1));
# "long": long-memory decays; a float: that constant) or f_pre (None: N(0,
# 1) + 2; "long": + 4; a float: that constant) and the i_pre scale.
SCAN_GRAD_SHAPES = [
    ("zamba2_train_4x1024", 45, 4, 1024, None),
    ("reset_a-30_1x1024", 0, 1, 1024, -30.0),
    ("long_memory_1x1024", 0, 1, 1024, "long"),
]
MLSTM_GRAD_SHAPES = [
    ("xlstm_train_4x512", 36, 4, 512, None, 1.0),
    ("forget_all_1x512", 0, 1, 512, -30.0, 1.0),
    ("long_memory_1x512", 0, 1, 512, "long", 1.0),
]


def plain_grads(fn, args, dout, dtype) -> list[torch.Tensor]:
    """Autograd of ``fn`` in ``dtype``, one batch row at a time (the rows
    are independent; the plain recurrences keep every step's state)."""
    out = [[] for _ in args]
    for j in range(args[0].shape[0]):
        leaves = [t[j:j + 1].detach().to(dtype).clone().requires_grad_()
                  for t in args]
        fn(*leaves).backward(dout[j:j + 1].to(dtype))
        for acc, t in zip(out, leaves):
            acc.append(t.grad)
        del leaves
    return [torch.cat(g) for g in out]


def backward_check(tag: str, op, plain, mod, shapes, inputs,
                   names: tuple[str, ...]) -> list[dict]:
    """Phases 39 and 40: per shape the gradient through ``op`` (the scan
    kernel under its autograd function, the backward kernel in its
    backward) against autograd of ``plain`` in f32 on the same values,
    each gradient tensor within SCAN_GRAD_RTOL·max|g_plain| (at least
    GRAD_ZERO of the shape's largest); two backward launches bit-equal;
    both gradients' distances from autograd of ``plain`` in f64 printed,
    each in units of its tensor's max|g_f64|."""
    print(f"[{tag}] limits, per gradient tensor against autograd of the "
          f"plain recurrence in f32 on the same values: |kernel - plain| <= "
          f"{SCAN_GRAD_RTOL}*max|g_plain| (max|g_plain| at least "
          f"{GRAD_ZERO} of the shape's largest gradient); two backward "
          f"launches bit-equal; distances from the f64 gradient printed")
    rows = []
    for i, shape in enumerate(shapes):
        name, count, b, s = shape[:4]
        args = inputs(i, shape)
        g = torch.Generator(device="cuda").manual_seed(SEED + 960 + i)
        dout = torch.randn(args[0].shape, generator=g, device="cuda")
        before = (mod.launches, mod.backward_launches)
        runs = []
        for _ in range(2):
            leaves = [t.clone().requires_grad_() for t in args]
            op(*leaves).backward(dout)
            runs.append([t.grad for t in leaves])
            del leaves
        torch.cuda.synchronize()
        moved = (mod.launches - before[0], mod.backward_launches - before[1])
        check(moved == (2, 2), f"{name}: forward and backward launches "
              f"moved {moved}, want (2, 2)")
        check(all(torch.equal(a, c) for a, c in zip(*runs)),
              f"{name}: two backward launches differ")
        got = runs[0]
        del runs
        refs = plain_grads(plain, args, dout, torch.float32)
        r64 = plain_grads(plain, args, dout, torch.float64)
        top = max(r.abs().max().item() for r in refs)
        errs, used, k64, p64 = {}, 0.0, {}, {}
        for n, t, ref, e in zip(names, got, refs, r64):
            check(t.shape == ref.shape and t.dtype == torch.float32,
                  f"{name}: d{n} {tuple(t.shape)} {t.dtype}")
            check(bool(torch.isfinite(t).all()), f"{name}: d{n} not finite")
            errs[n] = (t - ref).abs().max().item()
            limit = SCAN_GRAD_RTOL * max(ref.abs().max().item(),
                                         GRAD_ZERO * top)
            used = max(used, errs[n] / limit)
            scale = max(e.abs().max().item(), 1e-300)
            k64[n] = (t.double() - e).abs().max().item() / scale
            p64[n] = (ref.double() - e).abs().max().item() / scale
        print(f"[{tag}] {name:20s} {tuple(args[0].shape)} max_abs_err "
              + ", ".join(f"d{n} {e:.2e}" for n, e in errs.items())
              + f"; limit used {used:.4f}; vs f64 (of max|g_f64|): kernel "
              + ", ".join(f"{v:.1e}" for v in k64.values()) + "; plain "
              + ", ".join(f"{v:.1e}" for v in p64.values()))
        check(used <= 1.0, f"{name}: backward kernel vs plain exceeds its "
              f"limit {used:.3f}-fold")
        rows.append({"name": name, "per_forward": count, "batch": b, "S": s,
                     "max_abs_err": max(errs.values()), "errors": errs,
                     "limit_used": used, "kernel_vs_f64": k64,
                     "plain_vs_f64": p64})
        del args, dout, got, refs, r64
    torch.cuda.empty_cache()
    return rows


def scan_bwd_bounds(shape, cfg) -> dict:
    """The SSD scan's gradient: dy and the inputs read once, the four
    gradients written once, and the fewer operations of two ways: the
    adjoint recurrence at 13·P·N a step and head (the state again 3, its
    adjoint 2, dx, dB, dC and d a_log 2 each), or the chunked form at the
    kernel's chunk (per chunk and head the causal pairs' dy·x, dx, dB and
    dC, 2·L(L+1)/2·(2P + 2N), ten products of 2·L·P·N for the states, the
    adjoints and the carries, and C·Bᵀ once per chunk).  The bound is
    reckoned as ``scan_bounds`` reckons the forward's: that work as three
    bf16 products on the tensor cores, against the bytes;
    ``bound_f32_ms`` is the same work in f32 on the CUDA cores; ``ops`` is
    the f32 work, for TFLOP/s."""
    from repro_torch.models.ssm import ssm_dims
    _, _, b, s, _ = shape
    _, H, P, N = ssm_dims(cfg)
    L = 64
    lens = [min(L, s - t0) for t0 in range(0, s, L)]
    chunked = b * sum(l * (l + 1) * N + H * (l * (l + 1) * (2 * P + 2 * N)
                                             + 20 * l * P * N)
                      for l in lens)
    recurrence = b * H * s * 13 * P * N
    ops_ = min(chunked, recurrence)
    nbytes = 4 * b * s * (3 * H * P + 2 * H + 4 * N)
    f32 = roofline(ops_, nbytes)
    return {**roofline(3 * ops_, nbytes, peak=PEAK_BF16_OPS), "ops": ops_,
            "ops_form": "chunked at 64" if chunked < recurrence
            else "recurrence", "bound_f32_ms": f32["bound_ms"],
            "bound_f32_by": f32["bound_by"]}


def mlstm_bwd_kernel_ms(b: int, s: int, H: int, P: int) -> tuple[float, int]:
    """The least time the gradient's arithmetic could take, reckoned as
    ``mlstm_kernel_ms`` reckons the forward's, and the chunk at which (a
    chunk of S is the pairs form): per chunk of L steps and head the
    causal scores q·kᵀ again (L(L+1)·P) in f64 at the f32 CUDA cores'
    67 TFLOP/s; as three TF32 products at 495 TFLOP/s the four other pair
    products (dnum·vᵀ, dS·k, dSᵀ·q and the weighted dnum into dv,
    4·L(L+1)·P), where a state enters the chunk C's adjoint on q and the
    carry of dC (4·L·P²), and where a later chunk follows the state's
    carry and dk, dv from the carried dC (6·L·P²); the gates and the
    denominators, 20·L, at 67 TFLOP/s."""
    best = None
    for Q in (*MLSTM_CHUNKS, s):
        scores = tc = rest = 0
        for t0 in range(0, s, Q):
            L = min(Q, s - t0)
            scores += L * (L + 1) * P
            tc += 4 * L * (L + 1) * P + (4 * L * P * P if t0 else 0) \
                + (6 * L * P * P if t0 + L < s else 0)
            rest += 20 * L
        ms = b * H * ((scores + rest) / PEAK_F32_OPS
                      + 3 * tc / PEAK_TF32_OPS) * 1e3
        if best is None or ms < best[0]:
            best = (ms, Q)
    return best


def mlstm_bwd_bounds(shape, cfg) -> dict:
    """The mLSTM scan's gradient: dh, q, k, v, h and the gates read once,
    the five gradients written once; the bound is the arithmetic as
    ``mlstm_bwd_kernel_ms`` counts it, against the bytes; ``ops`` is the
    f32 work, the fewer of two ways: the pairs (t, s <= t) at 10·P each
    (q·k, dnum·v, dq, dk, dv) and O(S) for the gates, or the adjoint
    recurrence at 10·P² a step and head; ``bound_f32_ms`` is that work in
    f32 on the CUDA cores."""
    _, _, b, s, _, _ = shape
    H, P = cfg.num_heads, cfg.d_model // cfg.num_heads
    pairs = b * H * (s * (s + 1) // 2 * 10 * P + 20 * s)
    recurrence = b * H * s * 10 * P * P
    ops_ = min(pairs, recurrence)
    nbytes = 4 * b * s * H * (8 * P + 4)
    f32 = roofline(ops_, nbytes)
    ops_ms, chunk = mlstm_bwd_kernel_ms(b, s, H, P)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"ops": ops_, "bytes": nbytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_chunk": chunk,
            "ops_form": "pairs" if pairs < recurrence else "recurrence",
            "bound_f32_ms": f32["bound_ms"], "bound_f32_by": f32["bound_by"]}


def backward_timings(rows: list[dict], shapes, inputs, plain, bwd_kernel,
                     bounds, output=None) -> None:
    """Per shape the backward kernel alone (CUDA events, on the forward's
    inputs, ``output(*inputs)`` where the kernel also takes the forward's
    output, and a random output gradient) against its bound, and at the
    first (training) shape the plain version's backward: autograd of the
    plain recurrence on a kept graph."""
    for i, (shape, row) in enumerate(zip(shapes, rows)):
        args = inputs(i, shape)
        dout = torch.randn_like(args[0])
        extra = (output(*args),) if output else ()
        row.update(bounds(shape))
        row["ms"] = cuda_ms(lambda: bwd_kernel(dout, *args, *extra), iters=10)
        row["plain_ms"] = None
        if i == 0:
            leaves = [t.clone().requires_grad_() for t in args]
            out = plain(*leaves)
            row["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
                out, leaves, dout, retain_graph=True), iters=2, warmup=1)
            del leaves, out
        row["library_ms"] = None
        print(f"[time] backward {row['name']:20s} x{row['per_forward']:<2d} "
              f"kernel {row['ms']:.4f} ms ({row['ops'] / row['ms'] / 1e9:.2f} "
              f"TFLOP/s), bound {row['bound_ms']:.4f} ({row['bound_by']}; "
              f"{row['ops']:.4g} operations, {row['ops_form']}; f32 CUDA "
              f"cores {row['bound_f32_ms']:.4f})"
              + (f"; plain backward {row['plain_ms']:.2f} ms"
                 if row["plain_ms"] is not None else ""))
        del args, dout, extra
    torch.cuda.empty_cache()


def scan_bwd_times() -> None:
    """Both scans' backward kernels alone at phases 39's and 40's shapes,
    each first held as ``backward_check`` holds it (SCAN_GRAD_RTOL, two
    backward launches bit-equal), then per shape CUDA-event time (10
    calls, as ``backward_timings``), each device kernel's time
    (torch.profiler), TFLOP/s of the bound's work count and the bound
    (``scan_bwd_bounds``, ``mlstm_bwd_bounds``).  Only the wrappers' and
    ``ops``' signatures are used, so a copy of this file beside an older
    checkout times that checkout's kernels."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import mlstm_scan as ML
    from repro_torch.kernels.ref import mamba_scan_ref, mlstm_ref
    _build.library()
    torch.manual_seed(SEED)
    hcfg, xcfg = get_config(HYBRID_CONFIG), get_config(XLSTM_CONFIG)
    print(f"[scan-bwd] the backward kernels of {ROOT / 'src'}")
    for (tag, op, plain, mod, shapes, inputs, names, kernel, bounds,
         output) in (
            ("scan_grad", ops.mamba_scan, mamba_scan_ref, MS,
             SCAN_GRAD_SHAPES, lambda i, sh: scan_inputs(i, sh, hcfg),
             ("dtx", "a_log", "B", "C"), MS.mamba_scan_bwd_kernel,
             lambda sh: scan_bwd_bounds(sh, hcfg), None),
            ("mlstm_grad", ops.mlstm_scan, mlstm_ref, ML, MLSTM_GRAD_SHAPES,
             lambda i, sh: mlstm_inputs(i, sh, xcfg),
             ("q", "k", "v", "i_pre", "f_pre"), ML.mlstm_scan_bwd_kernel,
             lambda sh: mlstm_bwd_bounds(sh, xcfg), ML.mlstm_scan_kernel)):
        backward_check(tag, op, plain, mod, shapes, inputs, names)
        for i, shape in enumerate(shapes):
            args = inputs(i, shape)
            dout = torch.randn_like(args[0])
            extra = (output(*args),) if output else ()

            def call():
                return kernel(dout, *args, *extra)
            ms = cuda_ms(call, iters=10)
            by_kernel = device_ms_by_kernel(call) or {}
            bound = bounds(shape)
            device = sum(by_kernel.values()) if by_kernel else None
            parts = ", ".join(
                re.sub(r"^\(anonymous namespace\)::", "", n).split("(")[0]
                + f" {t:.4f}" for n, t in sorted(by_kernel.items()))
            print(f"[scan-bwd] {shape[0]:20s} {tuple(args[0].shape)}: "
                  f"events {ms:.4f} ms, on the card {fmt_ms(device)} "
                  f"({parts}); {bound['ops'] / ms / 1e9:.2f} TFLOP/s of "
                  f"the {bound['ops']:.4g} operations ({bound['ops_form']}"
                  f"); bound {bound['bound_ms']:.4f} ms "
                  f"({bound['bound_by']}), {ms / bound['bound_ms']:.1f}x it")
            del args, dout, extra
        torch.cuda.empty_cache()


HYBRID_MARKS = {"mamba_scan forward": ("mamba_scan_chunk_state",
                                       "mamba_scan_state_pass",
                                       "mamba_scan_chunk_output"),
                "mamba_scan backward": ("mamba_bwd_",),
                "flash forward": ("flash_attention",),
                "flash backward": ("flash_bwd_",)}
XLSTM_MARKS = {"mlstm_scan forward": DEVICE_KERNELS["mlstm_scan"],
               "mlstm_scan backward": ("mlstm_bwd_",)}


def recurrent_training_paths(smi: str) -> dict:
    """Phases 39-45: the scans' backward kernels against plain, then
    zamba2-2.7b at full width and depth and xlstm-1.3b at full width cut
    to XLSTM_TRAIN_LAYERS taking train steps, each one's f32 twin against
    ``ops.plain()``, and their timings."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import mlstm_scan as ML
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import mamba_scan_ref, mlstm_ref
    from repro_torch.models.api import hybrid_units, xlstm_units
    from repro_torch.train.trainer import init_train_state
    hcfg, xcfg = get_config(HYBRID_CONFIG), get_config(XLSTM_CONFIG)

    def h_inputs(i, shape):
        return scan_inputs(i, shape, hcfg)

    def x_inputs(i, shape):
        return mlstm_inputs(i, shape, xcfg)
    scan_rows = backward_check("scan_grad", ops.mamba_scan, mamba_scan_ref,
                               MS, SCAN_GRAD_SHAPES, h_inputs,
                               ("dtx", "a_log", "B", "C"))
    mlstm_rows = backward_check("mlstm_grad", ops.mlstm_scan, mlstm_ref, ML,
                                MLSTM_GRAD_SHAPES, x_inputs,
                                ("q", "k", "v", "i_pre", "f_pre"))
    print(f"[time] the backward kernels, {smi}; library: none, no PyTorch "
          f"call computes either scan's gradient")
    backward_timings(scan_rows, SCAN_GRAD_SHAPES, h_inputs, mamba_scan_ref,
                     MS.mamba_scan_bwd_kernel,
                     lambda sh: scan_bwd_bounds(sh, hcfg))
    backward_timings(mlstm_rows, MLSTM_GRAD_SHAPES, x_inputs, mlstm_ref,
                     ML.mlstm_scan_bwd_kernel,
                     lambda sh: mlstm_bwd_bounds(sh, xcfg),
                     output=ML.mlstm_scan_kernel)

    units, k = hybrid_units(hcfg)
    h_expect = train_expect(units, mamba_scan=units * k,
                            mamba_scan_bwd=units * k)
    htp = train_path(smi, hcfg, HYBRID_TRAIN_ROWS, HYBRID_TRAIN_SEQ,
                     h_expect, remat=True)
    h_times = train_timings(htp, smi, HYBRID_MARKS)
    h_record = {**htp["record"], "launches_per_step": h_expect,
                "timings": h_times}
    del htp
    torch.cuda.empty_cache()
    t_units, t_k = hybrid_units(dataclasses.replace(
        hcfg, num_layers=HYBRID_TWIN_LAYERS))
    h_twin = train_twin_path(HYBRID_CONFIG, HYBRID_TWIN_LAYERS,
                             HYBRID_TWIN_ROWS, HYBRID_TRAIN_SEQ,
                             train_expect(t_units, mamba_scan=t_units * t_k,
                                          mamba_scan_bwd=t_units * t_k))
    phase_time("39-43")

    x_train = dataclasses.replace(xcfg, num_layers=XLSTM_TRAIN_LAYERS)
    units, k = xlstm_units(x_train)
    x_expect = {"mlstm_scan": units * k, "mlstm_scan_bwd": units * k}
    xtp = train_path(smi, x_train, XLSTM_TRAIN_ROWS, XLSTM_TRAIN_SEQ,
                     x_expect, n_steps=XLSTM_TRAIN_STEPS)
    # The profile takes one unit at full width: a step of all twelve
    # records ~10^6 events, minutes for the profiler to read.
    ucfg = dataclasses.replace(xcfg, name=f"{xcfg.name}-one-unit",
                               num_layers=xcfg.xlstm_slstm_every)
    umodel, uts = train_setup(ucfg)
    utp = {"cfg": ucfg, "model": umodel, "ts": uts, "batch": xtp["batch"],
           "state": init_train_state(umodel, umodel.init(seed=SEED), uts)}
    x_times = train_timings(xtp, smi, XLSTM_MARKS, profile_tp=utp)
    x_record = {**xtp["record"], "launches_per_step": x_expect,
                "timings": x_times}
    del xtp, utp, umodel
    torch.cuda.empty_cache()
    t_units, t_k = xlstm_units(dataclasses.replace(
        xcfg, num_layers=XLSTM_TWIN_LAYERS))
    x_twin = train_twin_path(XLSTM_CONFIG, XLSTM_TWIN_LAYERS,
                             XLSTM_TWIN_ROWS, XLSTM_TRAIN_SEQ,
                             {"mlstm_scan": t_units * t_k,
                              "mlstm_scan_bwd": t_units * t_k})
    phase_time("44-45")
    return {"scan_grad_rows": scan_rows, "mlstm_grad_rows": mlstm_rows,
            hcfg.name: h_record, f"{hcfg.name}_f32_twin": h_twin,
            xcfg.name: x_record, f"{xcfg.name}_f32_twin": x_twin}


# --- the sharded launch path: the launcher, both policies, the dry run ---------

LAUNCH_CONFIG = "minicpm-2b"
LAUNCH_STEPS, LAUNCH_CKPT_EVERY, LAUNCH_FAIL_AT = 4, 2, 3
# The checkpointed restart's depth.  minicpm-2b's whole train state is 27 GB
# (bf16 parameters, f32 moments); the loop writes one at step 0 and one at
# its last step, and the card's machine stops a call that has written 45 GiB
# to its disk, so at full depth the launcher runs without checkpoints and
# the restart from a checkpoint runs at full width cut to 4 layers (5.2 GB
# a checkpoint, three of them).
LAUNCH_CUT_LAYERS = 4
LAUNCH_LOSS_RTOL = 1e-3   # only if the launcher's losses are not bit-equal
DRYRUN_CELLS = ("minicpm-2b@prefill_32k", "deepseek-moe-16b@prefill_32k")
DRYRUN_POLICIES = ("fused_seq", "layerwise_tp")
# deepseek-moe-16b@prefill_32k's per-device FLOPs and collective bytes on
# the 16x16 mesh before the expert-parallel MoE FFN and the masked lookup,
# when every rank ran the whole MoE FFN (and under layerwise_tp gathered
# the whole embedding table): the dry run of commit 6159077 on torch
# 2.13.0+cpu, the same command as phase 48's
DRYRUN_PARENT = {
    "fused_seq": {"flops": 5.326601e15, "all-gather": 145861115904,
                  "total": 145861115904,
                  "computed_replicated": ["moe_ffn"]},
    "layerwise_tp": {"flops": 5.317765e15, "all-gather": 149432827904,
                     "total": 187696414720,
                     "computed_replicated": ["embed", "moe_ffn"]}}
# Phase 50: the launcher on a MoE config at full width and depth
MOE_LAUNCH_CONFIG = "granite-moe-1b-a400m"


def launcher_args(policy: str, ckpt: Path, *extra: str,
                  arch: str = LAUNCH_CONFIG):
    from repro_torch.launch import train as LT
    return LT.parser().parse_args([
        "--arch", arch, "--mesh", "1x1", "--policy", policy,
        "--steps", str(LAUNCH_STEPS), "--global-batch", str(TRAIN_ROWS),
        "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--ckpt-dir",
        str(ckpt), *extra])


def split_step(model, ts, state, batch) -> dict:
    """One train step as ``make_train_step`` takes it, timed in two parts
    on the host clock around synchronised calls: the gradient
    (``make_grad_fn``) and the AdamW update, in ms."""
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.optim.schedule import make_schedule
    from repro_torch.train.trainer import make_grad_fn
    schedule = make_schedule(model.cfg.lr_schedule,
                             warmup=ts.schedule_warmup,
                             total=ts.schedule_total_steps)
    grad_fn = make_grad_fn(model, ts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, grads = grad_fn(state["params"], batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(ts.opt, state["params"], grads, state["opt"],
                 schedule(state["opt"]["step"] + 1))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    zero_launches()
    return {"grad_ms": (t1 - t0) * 1e3, "adamw_ms": (t2 - t1) * 1e3}


def plain_trainer(cfg, ts, expect: dict[str, int], init: list | None = None,
                  split: bool = False) -> dict:
    """The plain-tensor trainer (``make_train_step`` on plain tensors) from
    seed 0 on the launcher's batches: per-step losses and host-clock
    seconds, the final parameters on the host, and, when ``init`` is a
    list, the initial parameters appended to it (on the host); with
    ``split``, one more step after those, timed by ``split_step``."""
    from repro_torch import tree
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.models import build_model
    from repro_torch.train.trainer import init_train_state, make_train_step
    model = build_model(cfg)
    step_fn = make_train_step(model, ts)
    lm = model.init(0)
    if init is not None:
        init.extend(p.detach().cpu() for p in tree.leaves(lm.params))
    state = init_train_state(model, lm, ts)
    del lm
    losses, secs = [], []
    for s in range(LAUNCH_STEPS):
        batch = batch_for_step(cfg, s, TRAIN_ROWS, TRAIN_SEQ)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        secs.append(time.perf_counter() - t0)
        check_launches(expect, f"{cfg.name} plain trainer step {s}",
                       flash_route(cfg))
    final = [p.detach().cpu() for p in tree.leaves(state["params"])]
    parts = split_step(model, ts, state, batch_for_step(
        cfg, LAUNCH_STEPS, TRAIN_ROWS, TRAIN_SEQ)) if split else None
    del state
    torch.cuda.empty_cache()
    return {"losses": losses, "s": secs, "final": final, "split": parts}


def run_launcher(args, expect: dict[str, int], route: str, layers: int = 0,
                 fail_at: int = -1, routes: dict[str, int] | None = None,
                 after=None) -> dict:
    """``launch.train.run(args, layers=layers)`` in this process: each
    step's launches held to ``expect`` (on ``route``), its sharded routes
    to ``routes`` (none if not given) and step 0's collectives counted; a
    ``TransientError`` raised once at step ``fail_at`` (-1: none); every
    state leaf must be a DTensor on the 1x1 mesh.  ``after(run)``, if
    given, reads ``run``'s result (the state is still on the card) and
    its return goes to the record's ``after``.  The final parameters go to
    the host and the state is freed."""
    import shutil

    from repro_torch import tree
    from repro_torch.core.dtensor import is_dtensor
    from repro_torch.launch import train as LT
    from repro_torch.launch.comm import CommCounter
    from repro_torch.train.fault_tolerance import TransientError
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    launches: list[int] = []
    taken: list[dict] = []
    comm: dict = {}
    failed: list[int] = []

    @contextlib.contextmanager
    def counted(step: int):
        if step == fail_at and not failed:
            failed.append(step)
            print(f"  [launch] TransientError at step {step}")
            raise TransientError(f"injected at step {step}")
        zero_launches()
        counter = CommCounter() if not comm else None
        with counter if counter is not None else contextlib.nullcontext():
            yield
        torch.cuda.synchronize()
        launches.append(check_launches(
            expect, f"launcher step {step}", route)["flash_attention"])
        taken.append(check_routes(routes or {}, f"launcher step {step}"))
        if counter is not None:
            comm.update(counter.costs().record())

    t0 = time.perf_counter()
    out = LT.run(args, step_context=counted, layers=layers)
    run_s = time.perf_counter() - t0
    late = after(out) if after is not None else None
    state = out["state"]
    leaves = [x for k in ("params", "opt") for x in tree.leaves(state[k])
              if k == "params" or x.dim() > 0]
    check(all(is_dtensor(x) and tuple(x.device_mesh.shape) == (1, 1)
              for x in leaves), "a launcher state leaf is not a DTensor on "
          "the 1x1 mesh")
    placements = sorted({str(x.placements) for x in leaves})
    final = [p.to_local().detach().cpu() for p in
             tree.leaves(state["params"])]
    history, report = out["history"], out["report"]
    del out, state, leaves
    torch.cuda.empty_cache()
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    check(comm.get("total", -1) == 0, f"collectives on a 1x1 mesh: {comm}")
    return {"losses": [loss for _, loss, _ in history],
            "steps": [s for s, _, _ in history],
            "s": [secs for _, _, secs in history], "final": final,
            "launches": launches, "routes": taken, "collectives": comm,
            "placements": placements, "restarts": report.restarts,
            "run_s": run_s, "after": late}


def held_against_plain(tag: str, got: dict, plain: dict) -> dict:
    """The launcher's per-step losses against the plain trainer's: bit-equal,
    or within LAUNCH_LOSS_RTOL (and said); final parameters compared."""
    bit_equal = got["losses"] == plain["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   plain["losses"]))
    same = all(torch.equal(a, b) for a, b in zip(got["final"],
                                                 plain["final"]))
    print(f"[launch] {tag}: steps run {got['steps']} (restarts "
          f"{got['restarts']}), flash launches a step {got['launches']}, "
          f"step 0's collectives {got['collectives']}; state placements "
          f"{got['placements']}; launcher losses {got['losses']}; plain "
          f"trainer {plain['losses']}; bit-equal {bit_equal} (max rel "
          f"{rel:.3e}); final parameters bit-equal {same}; run "
          f"{got['run_s']:.1f} s; sharded routes a step {got['routes']}")
    check(bit_equal or rel <= LAUNCH_LOSS_RTOL,
          f"{tag}: launcher losses differ from the plain trainer's by "
          f"{rel:.3e}")
    check(same or not bit_equal, f"{tag}: the losses agree bit for bit but "
          f"the final parameters do not")
    return {k: v for k, v in got.items() if k != "final"} | {
        "plain_losses": plain["losses"], "plain_s": plain["s"],
        "bit_equal": bit_equal, "max_rel": rel,
        "final_params_bit_equal": same}


def launcher_path(smi: str) -> dict:
    """Phase 46 (a): ``python -m repro_torch.launch.train --arch minicpm-2b
    --mesh 1x1 --policy fused_seq`` in this process (``run``, within a
    one-rank NCCL group), 4x1024 bf16, 4 steps: at full width and depth
    without checkpoints (see LAUNCH_CUT_LAYERS), then at full width cut to
    4 layers with a checkpoint every 2 and a ``TransientError`` at step 3,
    restored from step 2's checkpoint and replayed.  Each run: every state
    leaf a DTensor on the 1x1 mesh, exactly one flash launch a layer a step
    on the tensor-core route, zero collective bytes in step 0
    (``launch/comm.py``); and the plain-tensor trainer from the same seed on
    the same batches: each step's loss equal to the launcher's bit for bit
    (else within LAUNCH_LOSS_RTOL, and the run says so), the replayed
    step's too, the final parameters bit-equal.  Returns the records and
    the initial parameters (host) for phase 47."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.launch import train as LT
    cfg = get_config(LAUNCH_CONFIG)
    ckpt = ROOT / "build" / "launch_ckpt"
    print(f"[launch] python -m repro_torch.launch.train --arch "
          f"{LAUNCH_CONFIG} --mesh 1x1 --policy fused_seq --steps "
          f"{LAUNCH_STEPS} --global-batch {TRAIN_ROWS} --seq {TRAIN_SEQ} "
          f"--lr {TRAIN_LR}, in this process (one-rank NCCL group), {smi}")
    args = launcher_args("fused_seq", ckpt, "--ckpt-every", "0")
    expect = train_expect(cfg.num_layers)
    full = run_launcher(args, expect, flash_route(cfg))
    init: list = []
    plain = plain_trainer(cfg, LT.train_config(args), expect, init,
                          split=True)
    full = held_against_plain(f"{cfg.name} full depth, --ckpt-every 0",
                              full, plain)
    cut_args = launcher_args("fused_seq", ckpt, "--ckpt-every",
                             str(LAUNCH_CKPT_EVERY))
    ccfg = dc.replace(cfg, name=f"{cfg.name}-{LAUNCH_CUT_LAYERS}-layers",
                      num_layers=LAUNCH_CUT_LAYERS)
    cut = run_launcher(cut_args, train_expect(LAUNCH_CUT_LAYERS),
                       flash_route(cfg), layers=LAUNCH_CUT_LAYERS,
                       fail_at=LAUNCH_FAIL_AT)
    check(cut["restarts"] == 1 and cut["steps"] == list(
        range(LAUNCH_STEPS)), f"the launcher's restart: {cut['steps']}")
    cut = held_against_plain(
        f"{ccfg.name}, --ckpt-every {LAUNCH_CKPT_EVERY}, a TransientError "
        f"at step {LAUNCH_FAIL_AT} (replayed from step "
        f"{LAUNCH_FAIL_AT - 1}'s checkpoint)", cut,
        plain_trainer(ccfg, LT.train_config(cut_args),
                      train_expect(LAUNCH_CUT_LAYERS)))
    check(cut["bit_equal"] and cut["final_params_bit_equal"],
          "the restarted launcher run is not bit-equal to the plain run")
    return {"full": full, "cut": cut, "init": init,
            "plain_split": plain["split"]}


def policy_step_path(launcher: dict) -> dict:
    """Phase 47 (b): one ``layerwise_tp`` step from the same seed (phase
    46's initial parameters) on the same batch as the launcher's step 0 at
    full depth: its loss bit-equal to ``fused_seq``'s (a 1x1 mesh moves
    nothing), 40 flash launches, zero collective bytes, and one masked
    lookup in the table, whose vocab spec stays ``Shard(0)`` on the
    size-1 ``model`` dim; then a step with remat (80 launches, one
    lookup), a step timed in two parts (``split_step``), and a forward of
    the DTensor state under ``ops.plain()`` (no launch, one lookup)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core.policies import get_policy
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.kernels import ops
    from repro_torch.launch import train as LT
    from repro_torch.launch.comm import CommCounter
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.train.trainer import (init_train_state, make_train_step,
                                           sharded)
    cfg = get_config(LAUNCH_CONFIG)
    route = flash_route(cfg)
    ts = LT.train_config(launcher_args("layerwise_tp", ROOT / "build"))
    model = build_model(cfg)
    policy = get_policy("layerwise_tp", make_mesh((1, 1), ("data", "model")),
                        cfg)
    # the seed's parameters, as phase 46's plain trainer drew them
    like = build_model(cfg, device="meta").init(0).params
    params = tree.unflatten(like, [p.cuda() for p in launcher["init"]])
    launcher["init"].clear()
    state = LT.shard_state(policy, init_train_state(model, params, ts))
    vocab = [str(p) for p in state["params"]["embed"].placements]
    check(state["params"]["embed"].placements[1].is_shard(0),
          f"layerwise_tp's table on the 1x1 mesh: {vocab}")
    counter = CommCounter()
    batch = LT.shard_batch(policy, batch_for_step(cfg, 0, TRAIN_ROWS,
                                                  TRAIN_SEQ))
    zero_launches()
    with counter:
        state, metrics = make_train_step(model, ts)(state, batch)
    loss = float(metrics["loss"])
    check_launches(train_expect(cfg.num_layers), "layerwise_tp step",
                   route)
    check_routes({"embed": 1}, "layerwise_tp step")
    comm = counter.costs().record()
    zero_launches()
    state, m_remat = make_train_step(model, dataclasses.replace(
        ts, remat=True))(state, LT.shard_batch(
            policy, batch_for_step(cfg, 1, TRAIN_ROWS, TRAIN_SEQ)))
    remat_loss = float(m_remat["loss"])
    check_launches(step_launches(train_expect(cfg.num_layers), True),
                   "layerwise_tp step with remat", route)
    check_routes({"embed": 1}, "layerwise_tp step with remat")
    # the DTensor step split into its gradient and AdamW (phase 49)
    split = split_step(model, ts, state, LT.shard_batch(
        policy, batch_for_step(cfg, LAUNCH_STEPS, TRAIN_ROWS, TRAIN_SEQ)))
    batch = LT.shard_batch(policy, batch_for_step(cfg, 2, TRAIN_ROWS,
                                                  TRAIN_SEQ))
    with torch.no_grad(), ops.plain(), sharded([state["params"]["embed"]]):
        logits, _ = model.forward(model.bind(state["params"]), batch)
        finite = bool(torch.isfinite(logits.to_local()).all())
    check_launches({}, "a DTensor forward under ops.plain()")
    check_routes({"embed": 1}, "a DTensor forward under ops.plain()")
    del state, logits
    torch.cuda.empty_cache()
    print(f"[launch] layerwise_tp on the same state and batch: loss {loss} "
          f"vs fused_seq's {launcher['full']['losses'][0]} (bit-equal "
          f"{loss == launcher['full']['losses'][0]}); collectives {comm}; "
          f"the table's placements {vocab}, one masked lookup a step; "
          f"{cfg.num_layers} flash launches; a remat step (loss "
          f"{remat_loss:.4f}) {2 * cfg.num_layers}; a forward under "
          f"ops.plain() none, logits finite {finite}")
    check(loss == launcher["full"]["losses"][0], "layerwise_tp's loss "
          "differs from fused_seq's on a 1x1 mesh")
    check(comm["total"] == 0, f"layerwise_tp collectives on 1x1: {comm}")
    check(math.isfinite(remat_loss) and finite, "a non-finite loss or logit")
    return {"loss": loss, "collectives": comm, "remat_loss": remat_loss,
            "split": split, "table_placements": vocab}


def start_dryruns() -> tuple[dict, float]:
    """Phase 48's dry runs, started: one subprocess per policy."""
    import os
    runs = {policy: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
         "single", "--cells", ",".join(DRYRUN_CELLS), "--policy", policy,
         "--out", str(ROOT / "build" / f"dryrun_{policy}.json")], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for policy in DRYRUN_POLICIES}
    return runs, time.perf_counter()


def dryrun_path(started: tuple[dict, float]) -> dict:
    """Phase 48 (c): ``python -m repro_torch.launch.dryrun --mesh single
    --cells minicpm-2b@prefill_32k,deepseek-moe-16b@prefill_32k`` for each
    policy, as users run it, in subprocesses run side by side (a fake group
    of 256 ranks, meta shards, on the CPU): exit 0, an ``ok`` record per
    cell with nothing computed replicated; per-device argument bytes, FLOPs
    and collective bytes by kind printed, deepseek's beside DRYRUN_PARENT's
    (every rank running the whole MoE FFN).  The subprocesses start with
    ``start_dryruns``, before phase 46, and run beside it."""
    runs, t0 = started
    out = {}
    for policy, proc in runs.items():
        stdout, stderr = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"dry run {policy} exited "
              f"{proc.returncode}: {stdout[-2000:]} {stderr[-2000:]}")
        recs = json.loads((ROOT / "build" / f"dryrun_{policy}.json")
                          .read_text())
        check([r["cell"] for r in recs] == list(DRYRUN_CELLS),
              f"dry run {policy}: {recs}")
        for rec in recs:
            check(rec["status"] == "ok" and not rec["computed_replicated"],
                  f"dry run {policy}: {rec}")
            coll = {k: v for k, v in rec["collectives"].items() if v}
            parent = DRYRUN_PARENT[policy] \
                if rec["cell"].startswith("deepseek") else None
            print(f"[dryrun] {rec['cell']} single_pod_16x16 (256 fake ranks) "
                  f"{policy}: exit 0, computed replicated none; per device: "
                  f"argument {rec['bytes_per_device']['argument']} B, "
                  f"{rec['flops_per_device']:.4e} FLOPs, collectives {coll}"
                  + (f"; before the expert-parallel FFN (commit 6159077, "
                     f"torch 2.13.0+cpu): "
                     f"{parent['flops']:.4e} FLOPs, all-gather "
                     f"{parent['all-gather']} B, total {parent['total']} B, "
                     f"computed replicated {parent['computed_replicated']}"
                     if parent else ""))
            out[f"{rec['cell']}/{policy}"] = rec
    ex = moe_exchange(DRYRUN_CELLS[1], 16, 16)
    print(f"[exchange] {DRYRUN_CELLS[1]} on 16x16 under fused_seq's sequence "
          f"shards, a device and MoE layer (from the shapes): the route's "
          f"all-gather + reduce-scatter {ex['gather_reduce_scatter']} B; an "
          f"all-to-all of the kept assignments there and back "
          f"{ex['all_to_all_static']} B in static buffers, "
          f"{ex['all_to_all_kept']} B sized by the data; slots computed "
          f"{ex['padding']:.2f}x the assignments routed")
    out["exchange"] = ex
    secs = time.perf_counter() - t0
    print(f"[dryrun] both policies in {secs:.1f} s (side by side, beside "
          f"phases 46-47)")
    return {**out, "s": secs}


def moe_exchange(cell: str, data: int, model: int) -> dict:
    """The MoE FFN's exchange a device and MoE layer under ``fused_seq``'s
    sequence shards (the hints), from the shapes of ``cell`` on a
    ``data`` x ``model`` mesh, in bytes of the activations' dtype: the
    route's all-gather of the tokens over ``model`` and reduce-scatter of
    the outputs (what ``launch/comm.py`` counts: output bytes), against an
    all-to-all of the kept assignments there and back, in static buffers
    (each expert's ``min(C, tokens of the rank)`` slots) and in buffers
    sized by the data (the kept assignments alone); and the padding
    factor, slots computed over assignments routed, on the rank's data
    group."""
    from repro_torch.configs import get_config
    from repro_torch.launch.cells import SHAPES
    from repro_torch.models.moe import capacity_for
    arch, shape = cell.split("@")
    cfg, sh = get_config(arch), SHAPES[shape]
    E, K, d = cfg.moe_num_experts, cfg.moe_top_k, cfg.d_model
    word = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    rows = sh.global_batch // data
    group, local = rows * sh.seq_len, rows * sh.seq_len // model
    C = capacity_for(sh.global_batch * sh.seq_len, cfg)
    return {"gather_reduce_scatter": (group + local) * d * word,
            "all_to_all_static": 2 * E * min(C, local) * d * word,
            "all_to_all_kept": 2 * local * K * d * word,
            "padding": E // model * min(C, group) / (group * K / model)}


def moe_launch_path(smi: str) -> dict:
    """Phase 50: ``python -m repro_torch.launch.train --arch
    granite-moe-1b-a400m --mesh 1x1`` in this process (within the one-rank
    NCCL group) at full width and depth (24 MoE layers, 32 experts, top-8,
    bf16), 4x1024, 4 steps, ``--ckpt-every 0``, under ``fused_seq`` and
    then ``layerwise_tp``.  Each run: every state leaf a DTensor, each step
    the expert-parallel MoE FFN once a layer (``core.dtensor.
    route_counts``), the masked lookup once where the table is
    vocab-sharded (``layerwise_tp``), one flash launch a layer on the
    tensor-core route, zero collective bytes in step 0; a forward of the
    final state under ``ops.plain()`` takes the same routes and launches
    nothing; each step's loss and the final parameters against the plain
    trainer from the same seed (bit-equal, or the loss within
    LAUNCH_LOSS_RTOL and the run says so)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.kernels import ops
    from repro_torch.launch import train as LT
    from repro_torch.models.api import dense_layers
    from repro_torch.train.trainer import sharded
    cfg = get_config(MOE_LAUNCH_CONFIG)
    moe_layers = cfg.num_layers - dense_layers(cfg)
    expect = train_expect(cfg.num_layers)
    route = flash_route(cfg)

    def plain_forward(routes: dict):
        def run(out: dict) -> dict:
            state, model, policy = out["state"], out["model"], out["policy"]
            batch = LT.shard_batch(policy, batch_for_step(
                cfg, LAUNCH_STEPS, TRAIN_ROWS, TRAIN_SEQ))
            zero_launches()
            with torch.no_grad(), ops.plain(), sharded(
                    tree.leaves(state["params"])):
                logits, _ = model.forward(model.bind(state["params"]),
                                          batch)
                finite = bool(torch.isfinite(logits.to_local()).all())
            torch.cuda.synchronize()
            check_launches({}, f"{policy.name}: a DTensor forward under "
                               f"ops.plain()")
            taken = check_routes(routes, f"{policy.name}: a DTensor forward "
                                         f"under ops.plain()")
            check(finite, f"{policy.name}: non-finite logits under "
                          f"ops.plain()")
            return {"routes": taken, "finite": finite}
        return run

    out: dict = {}
    plain = None
    for policy in ("fused_seq", "layerwise_tp"):
        args = launcher_args(policy, ROOT / "build" / "launch_ckpt",
                             "--ckpt-every", "0", arch=MOE_LAUNCH_CONFIG)
        print(f"[launch] python -m repro_torch.launch.train --arch "
              f"{MOE_LAUNCH_CONFIG} --mesh 1x1 --policy {policy} --steps "
              f"{LAUNCH_STEPS} --global-batch {TRAIN_ROWS} --seq {TRAIN_SEQ} "
              f"--lr {TRAIN_LR} --ckpt-every 0, in this process, {smi}")
        vocab_sharded = policy == "layerwise_tp"
        routes = {"moe_ffn": moe_layers, "embed": int(vocab_sharded)}
        got = run_launcher(args, expect, route, routes=routes,
                           after=plain_forward(routes))
        if plain is None:
            plain = plain_trainer(cfg, LT.train_config(args), expect)
        out[policy] = held_against_plain(
            f"{cfg.name} {policy}, full width and depth, --ckpt-every 0",
            got, plain)
        if not out[policy]["bit_equal"]:
            print(f"[launch] {cfg.name} {policy}: the losses differ from the "
                  f"plain trainer's from step "
                  f"{first_difference(got['losses'], plain['losses'])}")
    steps = {p: statistics.median(r["s"][1:]) * 1e3 for p, r in out.items()}
    plain_ms = statistics.median(plain["s"][1:]) * 1e3
    print(f"[time] {cfg.name} train step {TRAIN_ROWS}x{TRAIN_SEQ} bf16, host "
          f"clock around a synchronised step, median of steps 1-"
          f"{LAUNCH_STEPS - 1}, {smi}: launcher (DTensor state, 1x1 mesh) "
          + ", ".join(f"{p} {ms:.1f} ms" for p, ms in steps.items())
          + f"; plain trainer {plain_ms:.1f} ms")
    return {**out, "step_ms": steps, "plain_step_ms": plain_ms}


def first_difference(a: list, b: list) -> int:
    return next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)


def launch_paths(smi: str) -> dict:
    """Phases 46-50: the launcher, the second policy and the dry run, the
    launcher on granite-moe-1b-a400m under both policies, then minicpm's
    launcher step time beside the plain trainer's."""
    import torch.distributed as dist
    started = start_dryruns()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        launcher = launcher_path(smi)
        policies = policy_step_path(launcher)
        dry = dryrun_path(started)
        moe = moe_launch_path(smi)
    finally:
        dist.destroy_process_group()
        for proc in started[0].values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    # steps 1 onwards: step 0 pays first calls and the collective counter
    full = launcher["full"]
    launch_ms = statistics.median(full["s"][1:]) * 1e3
    plain_ms = statistics.median(full["plain_s"][1:]) * 1e3
    print(f"[time] {LAUNCH_CONFIG} train step {TRAIN_ROWS}x{TRAIN_SEQ} bf16, "
          f"host clock around a synchronised step, median of steps 1-"
          f"{LAUNCH_STEPS - 1}, {smi}: launcher (DTensor state, 1x1 mesh) "
          f"{launch_ms:.1f} ms, plain trainer {plain_ms:.1f} ms; launcher "
          f"overhead over the plain trainer {launch_ms - plain_ms:.1f} ms a "
          f"step; every step: launcher "
          f"{[round(t * 1e3, 1) for t in full['s']]} plain "
          f"{[round(t * 1e3, 1) for t in full['plain_s']]}")
    dsplit, psplit = policies["split"], launcher["plain_split"]
    print(f"[time] one step split, {smi}: DTensor state (1x1 mesh) gradient "
          f"{dsplit['grad_ms']:.1f} ms + AdamW {dsplit['adamw_ms']:.1f} ms; "
          f"plain state gradient {psplit['grad_ms']:.1f} ms + AdamW "
          f"{psplit['adamw_ms']:.1f} ms; of the difference, gradient "
          f"{dsplit['grad_ms'] - psplit['grad_ms']:.1f} ms, AdamW "
          f"{dsplit['adamw_ms'] - psplit['adamw_ms']:.1f} ms")
    return {"launcher": launcher, "layerwise_tp": policies, "dryrun": dry,
            "moe_launcher": moe, "launcher_step_ms": launch_ms,
            "plain_step_ms": plain_ms}


def gemma2_backward_timings(smi: str) -> dict:
    """Phase 54's kernel lines: the bf16 backward kernels alone at each of
    gemma2-2b's two training layers (GEMMA2_GRAD_SHAPES; 13 of each a
    step), CUDA events, against their bound (10·D a pair at 989 TFLOP/s
    against each input read and output written once) and the plain f32
    gradient (``ref.attention_ref_grad``, the yardstick the kernels
    replaced); no PyTorch call computes the softcapped function."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    plain_grad = getattr(ref.attention_ref_grad, "plain",
                         ref.attention_ref_grad)
    layers = get_config(GEMMA2_TRAIN_CONFIG).num_layers // 2
    rows = []
    for i, (name, B, H, KV, S, T, D, causal, window,
            softcap) in enumerate(GEMMA2_GRAD_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(SEED + 980 + i)
        q, k, v, do = (torch.randn(B * heads, n, D, generator=g,
                                   device="cuda").bfloat16()
                       for heads, n in ((H, S), (KV, T), (KV, T), (H, S)))
        kw = dict(causal=causal, window=window, softcap=softcap)
        out, lse, lo = FA.flash_attention_kernel(q, k, v, **kw, stats=True)
        ms = cuda_ms(lambda: FA.flash_attention_backward_kernel(
            q, k, v, out, lse, do, out_lo=lo, **kw), iters=5, warmup=1)
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        plain_ms = cuda_ms(lambda: plain_grad(qf, kf, vf, dof, **kw),
                           iters=1, warmup=1)
        bound = roofline(10 * D * B * H * flash_pairs(S, T, causal, window),
                         2 * D * (5 * B * H * S + 4 * B * KV * T)
                         + 4 * B * H * S, PEAK_BF16_OPS)
        print(f"[time] the bf16 backward kernels at {name} ({B}x{S}, {H}/"
              f"{KV} heads of {D}, window {window}, softcap {softcap}), "
              f"{smi}: {ms:.4f} ms (bound {bound['bound_ms']:.4f}, "
              f"{bound['bound_by']}, 10*D a pair; "
              f"{bound['ops'] / ms / 1e9:.1f} TFLOP/s of the 10*D); the "
              f"plain f32 backward {plain_ms:.4f} ms; x{layers} a step")
        rows.append({"name": name, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound["bound_ms"],
                     "bound_by": bound["bound_by"], "ops": bound["ops"]})
        del q, k, v, do, out, lse, lo, qf, kf, vf, dof
    torch.cuda.empty_cache()
    return {"rows": rows, **{key: layers * sum(r[key] for r in rows)
                             for key in ("ms", "plain_ms", "bound_ms")}}


def plain_step_memory(tp: dict) -> dict:
    """Why phase 53 takes remat: the gradient of ``tp``'s state and batch
    without it, printed with the peak device memory it reached or the
    allocation that failed (the card's 80 GB run out)."""
    from repro_torch.train.trainer import make_grad_fn
    ts = dataclasses.replace(tp["ts"], remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fits, why = True, ""
    try:
        make_grad_fn(tp["model"], ts)(tp["state"]["params"], tp["batch"])
    except torch.OutOfMemoryError as e:
        fits, why = False, str(e).split(". ")[0]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    print(f"[train] {tp['cfg'].name} gradient without remat at "
          f"{tp['rows']}x{tp['seq']}: "
          + ("fits" if fits else f"out of memory ({why})")
          + f", {peak:.2f} GB reached (torch.cuda.max_memory_allocated)")
    return {"fits": fits, "peak_gb": peak}


def gemma2_training_paths(smi: str, params: dict) -> dict:
    """Phases 53-55: gemma2-2b's training at full width and depth on
    phase 8's weights (``params``, kept on the host), every step with
    remat; its timings and its backward kernels at the training layers;
    its f32 twin."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(GEMMA2_TRAIN_CONFIG),
                              lr_schedule="wsd")
    tp = train_path(smi, cfg, GEMMA2_TRAIN_ROWS, GEMMA2_TRAIN_SEQ,
                    train_expect(cfg.num_layers), remat=True, params=params)
    tp["record"]["plain_step"] = plain_step_memory(tp)
    times = train_timings(tp, smi, FLASH_MARKS)
    times["backward_kernels"] = gemma2_backward_timings(smi)
    record = {**tp["record"], "timings": times}
    del tp
    torch.cuda.empty_cache()
    twin_cfg = get_config(GEMMA2_TRAIN_CONFIG)
    print(f"[train] {twin_cfg.name} f32 twin: layer 0 local (window "
          f"{twin_cfg.window_for_layer(0)}), layer 1 global; at 1x"
          f"{GEMMA2_TWIN_SEQ} the window leaves out keys of the rows past "
          f"{twin_cfg.window_for_layer(0)}")
    twin = train_twin_path(GEMMA2_TRAIN_CONFIG, GEMMA2_TWIN_LAYERS, 1,
                           GEMMA2_TWIN_SEQ,
                           train_expect(GEMMA2_TWIN_LAYERS))
    return {"train": record, "twin": twin}


def training_paths(smi: str, gemma2_params: dict) -> dict:
    """Phases 34-45 and 53-55: the flash gradient, gemma2-2b's training
    (phases 53-55, on phase 8's weights), minicpm-2b's training at full
    width and depth, its f32 twin, the restart, and the timings; then the
    scans' backward kernels and the hybrid and xLSTM training paths."""
    from repro_torch.configs import get_config
    grad_rows = flash_grad_check(SEED + 900)
    phase_time("34")
    gemma2 = gemma2_training_paths(smi, gemma2_params)
    del gemma2_params
    phase_time("53-55")
    cfg = get_config(TRAIN_CONFIG)
    tp = train_path(smi, cfg, TRAIN_ROWS, TRAIN_SEQ,
                    train_expect(cfg.num_layers))
    times = train_timings(tp, smi, FLASH_MARKS)
    times["attention"] = attention_timings(tp, smi)
    times["f32_backward"] = f32_backward_timings(smi)
    phase_time("35, 38")
    record = {**tp["record"], "timings": times}
    del tp
    torch.cuda.empty_cache()
    twin = train_twin_path(TRAIN_CONFIG, TRAIN_TWIN_LAYERS, TRAIN_ROWS,
                           TRAIN_SEQ, train_expect(TRAIN_TWIN_LAYERS))
    restart = restart_path()
    phase_time("36-37")
    recurrent = recurrent_training_paths(smi)
    return {"grad_rows": grad_rows, "train": record, "twin": twin,
            "restart": restart, GEMMA2_TRAIN_CONFIG: gemma2, **recurrent}


T0 = time.perf_counter()
_MARK = [0.0]


def phase_time(phases: str) -> None:
    """Prints the seconds ``phases`` took (since the last mark) and the
    script's time so far: the budget of the 1200 s limit, by phase."""
    now = time.perf_counter() - T0
    print(f"[time] phases {phases}: {now - _MARK[0]:.1f} s (script at "
          f"{now:.0f} s)")
    _MARK[0] = now


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    smi = card()
    if "--conv-times" in sys.argv[1:]:
        conv_times()
        return 0
    if "--scan-times" in sys.argv[1:]:
        scan_times()
        return 0
    if "--mlstm-times" in sys.argv[1:]:
        mlstm_times()
        return 0
    if "--xlstm-prefill-times" in sys.argv[1:]:
        xlstm_prefill_times()
        return 0
    if "--flash-bwd-times" in sys.argv[1:]:
        flash_bwd_times()
        return 0
    if "--scan-bwd-times" in sys.argv[1:]:
        scan_bwd_times()
        return 0
    build_s, ptxas = build()
    count_plain_flash_backward()
    phase_time("1-2")
    if "--launch-paths" in sys.argv[1:]:
        launch_paths(smi)
        print(f"[time] script {time.perf_counter() - T0:.0f} s")
        return 0
    rows = kernel_check()
    rows16 = kernel_check_bf16()
    model = model_path()
    model16 = model_path_bf16(model["net"].params)
    fwd = timings(rows, model)
    fwd.update(profile(model))
    fwd16 = timings_bf16(rows16, model16)
    halo = halo_path(model, smi)
    halo["bf16_groups"] = halo_groups_bf16(model16, smi)
    phase_time("3-6")
    del model["net"], model["x"]
    for key in ("net", "twin", "x"):
        del model16[key]

    from repro_torch.configs import get_config
    # deepseek-moe-16b's weights, drawn on the host beside phases 7-21
    moe_params = host_init(get_config(MOE_CONFIG))
    cfg = get_config(LM_CONFIG)
    expect = {"flash_attention": cfg.num_layers}
    flash_rows = flash_check(cfg, FLASH_SHAPES, SEED + 200)
    dim_rows = flash_head_dim_check(SEED + 250, FLASH_HEAD_DIM_SHAPES,
                                    torch.bfloat16)
    dim_rows += flash_head_dim_check(SEED + 260, FLASH_F32_HEAD_DIM_SHAPES,
                                     torch.float32)
    lm = prefill_path(cfg, PREFILL_S, expect)
    served = serve_path(cfg, lm, expect)
    flash_timings(flash_rows, cfg, FLASH_SHAPES, SEED + 200)
    lm_times = lm_timings(cfg, lm, PREFILL_S)
    phase_time("7-10")
    # phase 8's weights, kept on the host for gemma2-2b's training (phase
    # 53) rather than drawn again
    from repro_torch import tree
    gemma2_params = tree.map(lambda t: t.detach().to("cpu"),
                             lm["net"].params)
    del lm["model"], lm["net"], lm["batch"]
    torch.cuda.empty_cache()

    from repro_torch.models.api import hybrid_units
    hcfg = get_config(HYBRID_CONFIG)
    units, per_unit = hybrid_units(hcfg)
    h_expect = {"mamba_scan": units * per_unit, "flash_attention": units}
    from repro_torch.kernels.mamba_scan import mamba_scan_kernel
    from repro_torch.kernels.ref import mamba_scan_ref

    def h_inputs(i, shape):
        return scan_inputs(i, shape, hcfg)
    scan_rows = recurrence_check(
        "scan", mamba_scan_kernel, mamba_scan_ref, SCAN_SHAPES, h_inputs,
        scan_closed_form, SCAN_ATOL, "the reset shape also against (C_t.B_t) "
        "dtx_t", twice=True)
    scan_bf16 = scan_dtype_check(
        "scan", "mamba_scan", mamba_scan_ref, h_inputs(2, SCAN_SHAPES[2]),
        (0, 2, 3), SCAN_ATOL)
    h_flash_rows = flash_check(hcfg, HYBRID_FLASH_SHAPES, SEED + 300)
    hlm = prefill_path(hcfg, HYBRID_PREFILL_S, h_expect)
    h_served = serve_path(hcfg, hlm, h_expect)
    # The f32 twin: full width cut to one unit, held at every position.
    tcfg = dataclasses.replace(hcfg, name=f"{hcfg.name}-f32-twin",
                               num_layers=hcfg.hybrid_attn_every,
                               dtype="float32", param_dtype="float32")
    t_units, t_per_unit = hybrid_units(tcfg)
    t_expect = {"mamba_scan": t_units * t_per_unit,
                "flash_attention": t_units}
    tlm = prefill_path(tcfg, HYBRID_PREFILL_S, t_expect, limit=TWIN_ATOL,
                       every_position=True)
    twin = lm_record(tlm, serve_path(tcfg, tlm, t_expect, limit=TWIN_ATOL))
    del tlm
    torch.cuda.empty_cache()
    recurrence_timings(scan_rows, SCAN_SHAPES, h_inputs, mamba_scan_kernel,
                       mamba_scan_ref, lambda sh: scan_bounds(sh, hcfg),
                       "the SSD scan")
    flash_timings(h_flash_rows, hcfg, HYBRID_FLASH_SHAPES, SEED + 300)
    h_times = lm_timings(hcfg, hlm, HYBRID_PREFILL_S)
    phase_time("11-16")
    del hlm["model"], hlm["net"], hlm["batch"]
    torch.cuda.empty_cache()

    from repro_torch.models.api import xlstm_units
    xcfg = get_config(XLSTM_CONFIG)
    x_units, x_per_unit = xlstm_units(xcfg)
    x_expect = {"mlstm_scan": x_units * x_per_unit}
    from repro_torch.kernels.mlstm_scan import mlstm_scan_kernel
    from repro_torch.kernels.ref import mlstm_ref

    def x_inputs(i, shape):
        return mlstm_inputs(i, shape, xcfg)
    mlstm_rows = recurrence_check(
        "mlstm", mlstm_scan_kernel, mlstm_ref, MLSTM_SHAPES, x_inputs,
        mlstm_closed_form, MLSTM_ATOL, MLSTM_CLOSED_NOTE, twice=True,
        exact=in_f64(mlstm_ref))
    mlstm_bf16 = scan_dtype_check(
        "mlstm", "mlstm_scan", mlstm_ref, x_inputs(2, MLSTM_SHAPES[2]),
        (0, 1, 2), MLSTM_ATOL)
    xlm = prefill_path(xcfg, XLSTM_PREFILL_S, x_expect, limit=None)
    x_served = serve_path(xcfg, xlm, x_expect, limit=None)
    # The same prefill in f32 at full width cut to XLSTM_F32_LAYERS, held
    # at every position.
    x32cfg = dataclasses.replace(xcfg, name=f"{xcfg.name}-f32",
                                 num_layers=XLSTM_F32_LAYERS,
                                 dtype="float32", param_dtype="float32")
    x32_units, x32_per_unit = xlstm_units(x32cfg)
    x32 = lm_record(prefill_path(x32cfg, XLSTM_PREFILL_S,
                                 {"mlstm_scan": x32_units * x32_per_unit},
                                 limit=TWIN_ATOL, every_position=True))
    torch.cuda.empty_cache()
    # The f32 twin: full width, one unit, held at every position.
    xtcfg = dataclasses.replace(xcfg, name=f"{xcfg.name}-f32-twin",
                                num_layers=xcfg.xlstm_slstm_every,
                                dtype="float32", param_dtype="float32")
    xt_units, xt_per_unit = xlstm_units(xtcfg)
    xt_expect = {"mlstm_scan": xt_units * xt_per_unit}
    xtlm = prefill_path(xtcfg, XLSTM_PREFILL_S, xt_expect, limit=TWIN_ATOL,
                        every_position=True)
    x_twin = lm_record(xtlm, serve_path(xtcfg, xtlm, xt_expect,
                                        limit=TWIN_ATOL))
    del xtlm
    torch.cuda.empty_cache()
    recurrence_timings(mlstm_rows, MLSTM_SHAPES, x_inputs, mlstm_scan_kernel,
                       mlstm_ref, lambda sh: mlstm_bounds(sh, xcfg),
                       "the mLSTM recurrence")
    # The profile takes one unit at full width (the unit the f32 twin
    # holds): the sLSTM's host loop over 2048 steps makes a prefill of all
    # twelve ~10^6 profiler events, minutes to read.
    ucfg = dataclasses.replace(xcfg, name=f"{xcfg.name}-one-unit",
                               num_layers=xcfg.xlstm_slstm_every)
    from repro_torch.models import build_model
    umodel = build_model(ucfg)
    x_times = lm_timings(xcfg, xlm, XLSTM_PREFILL_S, profile_lm={
        "model": umodel, "net": umodel.init(seed=SEED),
        "batch": xlm["batch"], "launches": {"mlstm_scan": xt_expect[
            "mlstm_scan"]}})
    del umodel
    del xlm["model"], xlm["net"], xlm["batch"]
    torch.cuda.empty_cache()

    phase_time("17-21")
    d = decoder_lm_paths(smi, moe_params)
    phase_time("22-27")
    mcfg, pcfg, mlm, m_times = d["mcfg"], d["pcfg"], d["mlm"], d["m_times"]
    m_flash_rows, p_flash_rows = d["m_flash_rows"], d["p_flash_rows"]
    q_flash_rows, config_runs = d["q_flash_rows"], d["config_runs"]
    w = whisper_paths(smi)
    phase_time("28-33")
    wcfg, wlm, w_times = w["wcfg"], w["wlm"], w["w_times"]
    w_flash_rows = w["w_flash_rows"]
    tr = training_paths(smi, gemma2_params)
    del gemma2_params
    tt = tr["train"]["timings"]
    la = launch_paths(smi)
    phase_time("46-50")

    check(sum(r["per_forward"] for r in rows) == CONVS_PER_FORWARD,
          "CONV_SHAPES do not add up to one forward")
    check(sum(r["per_forward"] for r in flash_rows) == cfg.num_layers,
          "FLASH_SHAPES do not add up to one prefill forward")
    check(sum(r["per_forward"] for r in h_flash_rows) == units,
          "HYBRID_FLASH_SHAPES do not add up to one prefill forward")
    check(sum(r["per_forward"] for r in scan_rows) == units * per_unit,
          "SCAN_SHAPES do not add up to one prefill forward")
    check(sum(r["per_forward"] for r in mlstm_rows) == x_units * x_per_unit,
          "MLSTM_SHAPES do not add up to one prefill forward")
    check(sum(r["per_forward"] for r in m_flash_rows) == mcfg.num_layers,
          "MOE_FLASH_SHAPES do not add up to one prefill forward")
    check(sum(r["per_forward"] for r in p_flash_rows) == CONFIG_LAYERS,
          "PHI3_FLASH_SHAPES do not add up to one prefill forward")

    def totals(rs: list[dict]) -> dict:
        """A kernel's numbers summed over the launches of one forward; no
        library time if a shape has none."""
        ops_ms, bytes_ms = per_forward(rs, "ops_ms"), per_forward(rs,
                                                                  "bytes_ms")
        no_library = any(r["library_ms"] is None for r in rs)
        return {"ms": per_forward(rs, "ms"),
                "plain_ms": per_forward(rs, "plain_ms"),
                "bound_ms": per_forward(rs, "bound_ms"),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": (None if no_library
                               else per_forward(rs, "library_ms"))}

    def train_totals(rs: list[dict]) -> dict:
        """A backward kernel's numbers over one train step: its launches at
        the training shape, the first of ``rs`` (the plain backward is
        timed there only)."""
        r, n = rs[0], rs[0]["per_forward"]
        return {"ms": n * r["ms"], "plain_ms": n * r["plain_ms"],
                "bound_ms": n * r["bound_ms"], "bound_by": r["bound_by"],
                "bound_f32_ms": n * r["bound_f32_ms"], "library_ms": None}

    def layer_totals(times: dict, keys: dict[str, str], n: int) -> dict:
        """One layer's times (``keys``: the line's name -> the record's)
        times the ``n`` launches of a train step."""
        return {k: n * times[src] for k, src in keys.items()}

    train_layers = get_config(TRAIN_CONFIG).num_layers
    g2 = tr[GEMMA2_TRAIN_CONFIG]
    g2_bwd = g2["train"]["timings"]["backward_kernels"]
    h_flash = totals(h_flash_rows)
    m_flash, p_flash = totals(m_flash_rows), totals(p_flash_rows)
    w_flash = totals(w_flash_rows)
    enc32 = next(r for r in w_flash_rows
                 if r["name"] == "b1_s1500_enc_d64_f32")
    kernels = {"kernels": [{
        "name": "fused_conv", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_conv_sm90.cu",
        "replaces": "src/repro/kernels/fused_conv.py:82",
        "launches": model["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **totals(rows),
        "bound_is": "three bf16 products on the tensor cores (989 TFLOP/s)",
        "bound_f32_ms": per_forward(rows, "bound_f32_ms"),
        **({} if any(r["device_ms"] is None or r["library_device_ms"] is None
                     for r in rows) else {
            "device_ms": per_forward(rows, "device_ms"),
            "library_device_ms": per_forward(rows, "library_device_ms")}),
        "times_are": f"sums over the {CONVS_PER_FORWARD} launches of one "
                     f"batch-{BATCH} forward; per shape in chip_smoke.json",
    }, {
        "name": "fused_conv_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_conv_sm90.cu",
        "replaces": "src/repro/kernels/fused_conv.py:82",
        "launches": model16["launches"],
        "launches_are": "the bf16 route's (fused_conv_bf16_sm90_kernel) in "
                        "the bf16 ResNet18's requests and fused groups; "
                        "fused_conv's count the f32 route's",
        "max_abs_err": max(r["max_abs_err"] for r in rows16),
        "limit_used": max(r["limit_used"] for r in rows16),
        **totals(rows16),
        "bound_is": "one bf16 product on the tensor cores (989 TFLOP/s), or "
                    "its bf16 bytes",
        **({} if any(r["device_ms"] is None or r["library_device_ms"] is None
                     for r in rows16) else {
            "device_ms": per_forward(rows16, "device_ms"),
            "library_device_ms": per_forward(rows16, "library_device_ms")}),
        "library_is": "cuDNN's bf16 conv2d, channels-last, no epilogue",
        "times_are": f"sums over the {CONVS_PER_FORWARD} launches of one "
                     f"batch-{BATCH} bf16 forward; per shape in "
                     f"chip_smoke.json",
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "launches": lm["launches"]["flash_attention"],
        "launches_by_route": "every bf16 launch on wgmma_bf16 "
                             "(flash_attention_sm90.cu), every f32 one on "
                             "simt_f32 (flash_attention.cu), held per path",
        "f32_route": {"source": "src/repro_torch/kernels/csrc/"
                                "flash_attention.cu",
                      "launches": twin["launches"]["flash_attention"],
                      "in": f"the {tcfg.name} prefill",
                      **{key: enc32[key] for key in (
                          "ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "max_abs_err")},
                      "times_are": f"one launch at {enc32['name']} "
                                   f"({wcfg.name}'s f32 encoder clip)"},
        "library_mask_ms": per_forward(flash_rows, "library_mask_ms"),
        "max_abs_err": max(r["max_abs_err"] for r in (
            flash_rows + dim_rows + h_flash_rows + m_flash_rows
            + p_flash_rows + q_flash_rows + w_flash_rows)),
        **totals(flash_rows),
        "times_are": f"sums over the {cfg.num_layers} launches of one "
                     f"1x{PREFILL_S} {cfg.name} prefill; per shape in "
                     f"chip_smoke.json",
        hcfg.name: {"launches": hlm["launches"]["flash_attention"],
                    **h_flash, "library_mask_ms": per_forward(
                        h_flash_rows, "library_mask_ms"),
                    "times_are": f"sums over the {units} launches of one "
                                 f"1x{HYBRID_PREFILL_S} prefill"},
        mcfg.name: {"launches": mlm["launches"]["flash_attention"],
                    **m_flash, "library_mask_ms": per_forward(
                        m_flash_rows, "library_mask_ms"),
                    "times_are": f"sums over the {mcfg.num_layers} launches "
                                 f"of one 1x{MOE_PREFILL_S} prefill"},
        pcfg.name: {"launches": config_runs[pcfg.name]["launches"][
                        "flash_attention"],
                    **p_flash, "library_mask_ms": per_forward(
                        p_flash_rows, "library_mask_ms"),
                    "times_are": f"sums over the {CONFIG_LAYERS} launches "
                                 f"of one 1x4096 prefill cut to "
                                 f"{CONFIG_LAYERS} layers (D=96)"},
        wcfg.name: {"launches": wlm["launches"]["flash_attention"],
                    "f32_launches": w["w32"]["launches"]["flash_attention"],
                    **w_flash, "library_mask_ms": per_forward(
                        w_flash_rows, "library_mask_ms"),
                    "times_are": f"sums over the "
                                 f"{wlm['launches']['flash_attention']} "
                                 f"launches of one {WHISPER_ROWS}x"
                                 f"({wcfg.encoder_seq_len} frames + "
                                 f"{WHISPER_TOKENS} tokens) bf16 forward "
                                 f"(D=64)"},
        "training": {
            "config": f"{TRAIN_CONFIG} train step, {TRAIN_ROWS}x"
                      f"{TRAIN_SEQ}, bf16",
            "launches": tr["train"]["steps"][0]["launches"][
                "flash_attention"],
            "remat_launches": tr["train"]["steps"][-1]["launches"][
                "flash_attention"],
            "gradient_max_abs_err": max(r["max_abs_err"]
                                        for r in tr["grad_rows"]),
            "gradient_limit_used": max(r["limit_used"]
                                       for r in tr["grad_rows"]),
            **{k: tt["attention"][k] for k in (
                "forward_ms", "fwd_bwd_ms", "backward_kernel_ms",
                "backward_ms", "plain_fwd_bwd_ms", "library_fwd_bwd_ms",
                "bound_ms", "bound_by")},
            "backward_is": "the backward kernels (flash_attention_bwd, "
                           "next entry); backward_ms is the plain f32 "
                           "gradient they replaced (ref.attention_ref_grad)",
            "library_is": "F.scaled_dot_product_attention forward + "
                          "backward, is_causal (the same function)",
            "times_are": "one layer's attention (CUDA events); x"
                         f"{get_config(TRAIN_CONFIG).num_layers} per step"},
        "launcher": {
            "config": f"python -m repro_torch.launch.train --arch "
                      f"{LAUNCH_CONFIG} --mesh 1x1 --policy fused_seq, "
                      f"{TRAIN_ROWS}x{TRAIN_SEQ} bf16, DTensor state",
            "launches": la["launcher"]["full"]["launches"],
            "cut_launches": la["launcher"]["cut"]["launches"],
            "route": "local_map onto the local shards (kernels/ops.py)",
            MOE_LAUNCH_CONFIG: {
                p: la["moe_launcher"][p]["launches"]
                for p in ("fused_seq", "layerwise_tp")}},
    }, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "replaces_is": "the gradient jax.grad takes of attention_scores "
                       "(src/repro/models/layers.py:114); the Pallas kernel "
                       "has no backward",
        "launches": tr["train"]["steps"][0]["launches"][
            "flash_attention_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in tr["grad_rows"]
                           if r["route"] == "wgmma_bf16"),
        "limit_used": max(r["limit_used"] for r in tr["grad_rows"]
                          if r["route"] == "wgmma_bf16"),
        **layer_totals(tt["attention"], {
            "ms": "backward_kernel_ms", "plain_ms": "backward_ms",
            "bound_ms": "backward_bound_ms",
            "library_ms": "library_backward_ms"}, train_layers),
        "bound_by": tt["attention"]["backward_bound_by"],
        "bound_is": "10*D operations a visible pair (five products) at 989 "
                    "TFLOP/s; the kernel does 16*D (S and dP once, P and dS "
                    "as hi + lo bf16), 20*D at D = 128 and 256",
        "library_is": "the backward of F.scaled_dot_product_attention, "
                      "is_causal (torch.autograd.grad on its graph)",
        "launches_by_route": "every bf16 backward on bwd_tc_bf16 (wgmma, "
                             "every head dim), every f32 one on "
                             "bwd_simt_f32, held per path",
        "times_are": f"one layer's backward (CUDA events) x{train_layers}: "
                     f"the launches of one {TRAIN_CONFIG} "
                     f"{TRAIN_ROWS}x{TRAIN_SEQ} bf16 train step",
        GEMMA2_TRAIN_CONFIG: {
            "config": f"{GEMMA2_TRAIN_CONFIG} train step, "
                      f"{GEMMA2_TRAIN_ROWS}x{GEMMA2_TRAIN_SEQ}, bf16, remat",
            "launches": g2["train"]["steps"][0]["launches"][
                "flash_attention_bwd"],
            "max_abs_err": max(r["max_abs_err"] for r in tr["grad_rows"]
                               if r["D"] == 256 and r["route"] ==
                               "wgmma_bf16"),
            "limit_used": max(r["limit_used"] for r in tr["grad_rows"]
                              if r["D"] == 256 and r["route"] ==
                              "wgmma_bf16"),
            **{key: g2_bwd[key] for key in ("ms", "plain_ms", "bound_ms")},
            "bound_by": g2_bwd["rows"][0]["bound_by"],
            "library_ms": None,
            "library_is": "none: SDPA has no softcap, so computes another "
                          "function at gemma2's layers",
            "times_are": "one launch at each training layer (CUDA events) "
                         "x13 each: the launches of one train step"},
    }, {
        "name": "flash_attention_bwd_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "replaces_is": "as flash_attention_bwd, for f32 inputs",
        "launches": tr["twin"]["launches"]["flash_attention_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in tr["grad_rows"]
                           if r["route"] == "simt_f32"),
        "limit_used": max(r["limit_used"] for r in tr["grad_rows"]
                          if r["route"] == "simt_f32"),
        **layer_totals(tt["f32_backward"], {
            "ms": "ms", "plain_ms": "plain_ms", "bound_ms": "bound_ms",
            "library_ms": "library_ms"}, TRAIN_TWIN_LAYERS),
        "bound_by": tt["f32_backward"]["bound_by"],
        "bound_is": "10*D operations a visible pair at 67 TFLOP/s (f32 on "
                    "the CUDA cores); the kernel does the 10*D once a pair, "
                    "and the masked parts of causal diagonal tiles",
        "library_is": "the backward of F.scaled_dot_product_attention in "
                      "f32, is_causal, TF32 off",
        "launches_by_route": "every f32 backward on bwd_simt_f32 (two "
                             "launches a call: prep and the main kernel), "
                             "held per path",
        "times_are": f"one layer's backward (CUDA events) "
                     f"x{TRAIN_TWIN_LAYERS}: the launches of one step of "
                     f"the {TRAIN_CONFIG} f32 twin ({TRAIN_TWIN_LAYERS} "
                     f"layers, {TRAIN_ROWS}x{TRAIN_SEQ})",
    }, {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan_sm90.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:62",
        "launches": hlm["launches"]["mamba_scan"],
        "max_abs_err": max(r["max_abs_err"] for r in scan_rows),
        **totals(scan_rows),
        "library": "none: no single PyTorch call computes the SSD scan",
        "times_are": f"sums over the {units * per_unit} launches of one "
                     f"1x{HYBRID_PREFILL_S} {hcfg.name} prefill; per shape "
                     f"in chip_smoke.json",
    }, {
        "name": "mlstm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_scan_sm90.cu",
        "replaces": "src/repro/kernels/mlstm_scan.py:62",
        "launches": xlm["launches"]["mlstm_scan"],
        "max_abs_err": max(r["max_abs_err"] for r in mlstm_rows),
        **totals(mlstm_rows),
        "bound_is": "f64 scores at 67 TFLOP/s, the rest as three TF32 "
                    "products at 495 TFLOP/s",
        "bound_f32_ms": per_forward(mlstm_rows, "bound_f32_ms"),
        "library": "none: no single PyTorch call computes the mLSTM "
                   "recurrence",
        "times_are": f"sums over the {x_units * x_per_unit} launches of one "
                     f"1x{XLSTM_PREFILL_S} {xcfg.name} prefill; per shape "
                     f"in chip_smoke.json",
    }, {
        "name": "mamba_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan_bwd_sm90.cu",
        "replaces": "src/repro/models/ssm.py:82",
        "replaces_is": "jax.grad of the chunked SSD in jnp; the Pallas "
                       "kernel src/repro/kernels/mamba_scan.py:62 has no "
                       "backward",
        "launches": tr[hcfg.name]["steps"][0]["launches"]["mamba_scan_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in tr["scan_grad_rows"]),
        "limit_used": max(r["limit_used"] for r in tr["scan_grad_rows"]),
        **train_totals(tr["scan_grad_rows"]),
        "library": "none: no PyTorch call computes the SSD scan's gradient",
        "times_are": f"sums over the {units * per_unit} launches of one "
                     f"{HYBRID_TRAIN_ROWS}x{HYBRID_TRAIN_SEQ} {hcfg.name} "
                     f"train step; per shape in chip_smoke.json",
    }, {
        "name": "mlstm_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_scan_bwd_sm90.cu",
        "replaces": "src/repro/models/xlstm.py:54",
        "replaces_is": "jax.grad of the mLSTM lax.scan; the Pallas kernel "
                       "src/repro/kernels/mlstm_scan.py:62 has no backward",
        "launches": tr[xcfg.name]["steps"][0]["launches"]["mlstm_scan_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in tr["mlstm_grad_rows"]),
        "limit_used": max(r["limit_used"] for r in tr["mlstm_grad_rows"]),
        **train_totals(tr["mlstm_grad_rows"]),
        "library": "none: no PyTorch call computes the mLSTM scan's "
                   "gradient",
        "times_are": f"sums over the {x_units * x_per_unit} launches of one "
                     f"{XLSTM_TRAIN_ROWS}x{XLSTM_TRAIN_SEQ} {xcfg.name} "
                     f"train step at full depth; launches counts those of "
                     f"phase 44's step at {XLSTM_TRAIN_LAYERS} layers; per "
                     f"shape in chip_smoke.json",
    }]}

    record = {"card": smi, "torch": torch.__version__,
              "build_s": build_s, "ptxas": ptxas,
              "shapes": rows, **fwd, **model, "halo": halo,
              "bf16": {"shapes": rows16, **fwd16, **model16},
              "scan_bf16": scan_bf16, "mlstm_bf16": mlstm_bf16,
              "flash_shapes": flash_rows, "flash_head_dim_shapes": dim_rows,
              cfg.name: lm_record(lm, served, lm_times),
              "scan_shapes": scan_rows, "hybrid_flash_shapes": h_flash_rows,
              hcfg.name: lm_record(hlm, h_served, h_times),
              f"{hcfg.name}_f32_twin": twin, "mlstm_shapes": mlstm_rows,
              xcfg.name: lm_record(xlm, x_served, x_times),
              x32cfg.name: x32, f"{xcfg.name}_f32_twin": x_twin,
              "moe_flash_shapes": m_flash_rows,
              "phi3_flash_shapes": p_flash_rows,
              "qwen3_flash_shapes": q_flash_rows,
              mcfg.name: lm_record(mlm, d["m_served"], m_times),
              f"{mcfg.name}_f32_twin": d["m_twin"], "configs": config_runs,
              "whisper_flash_shapes": w_flash_rows,
              wcfg.name: lm_record(wlm, w["w_served"], w_times),
              w["w32cfg"].name: w["w32"], "serve_lm_torch": w["example"],
              "training": tr, "launch": la, **kernels}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    by_name = {k["name"]: k for k in kernels["kernels"]}
    print(f"[summary] forward {fwd['forward_ms']:.3f} ms; median request "
          f"{statistics.median(model['request_latency_ms']):.3f} ms; "
          f"fused_conv {kernels['kernels'][0]['ms']:.3f} ms per forward; "
          f"bf16 forward {fwd16['forward_ms']:.3f} ms with fused_conv_bf16 "
          f"{by_name['fused_conv_bf16']['ms']:.3f} ms; "
          f"{cfg.name} prefill 1x{PREFILL_S} {lm_times['prefill_ms']:.2f} ms "
          f"with flash_attention {by_name['flash_attention']['ms']:.2f} ms; "
          f"decode "
          f"step {lm_times['decode_step_ms']:.3f} ms at batch {SERVE_BATCH}; "
          f"{hcfg.name} prefill 1x{HYBRID_PREFILL_S} "
          f"{h_times['prefill_ms']:.2f} ms with mamba_scan "
          f"{by_name['mamba_scan']['ms']:.2f} ms and flash_attention "
          f"{h_flash['ms']:.2f} ms; decode step "
          f"{h_times['decode_step_ms']:.3f} ms at batch {SERVE_BATCH}; "
          f"{xcfg.name} prefill 1x{XLSTM_PREFILL_S} "
          f"{x_times['prefill_ms']:.2f} ms with mlstm_scan "
          f"{by_name['mlstm_scan']['ms']:.2f} ms; decode step "
          f"{x_times['decode_step_ms']:.3f} ms at batch {SERVE_BATCH}; "
          f"{mcfg.name} prefill 1x{MOE_PREFILL_S} "
          f"{m_times['prefill_ms']:.2f} ms with flash_attention "
          f"{m_flash['ms']:.2f} ms; decode step "
          f"{m_times['decode_step_ms']:.3f} ms at batch {SERVE_BATCH}; "
          f"{wcfg.name} forward {WHISPER_ROWS}x({wcfg.encoder_seq_len} "
          f"frames + {WHISPER_TOKENS} tokens) {w_times['prefill_ms']:.2f} ms "
          f"with flash_attention {w_flash['ms']:.2f} ms; decode step "
          f"{w_times['decode_step_ms']:.3f} ms at batch {SERVE_BATCH}; "
          f"{TRAIN_CONFIG} train step {TRAIN_ROWS}x{TRAIN_SEQ} "
          f"{tt['step_ms']:.1f} ms ({tt['tokens_per_s']:.0f} tokens/s, "
          f"{tt['mfu']:.3f} of peak by 6*N*tokens; the flash backward "
          f"{by_name['flash_attention_bwd']['ms']:.1f} ms of it); "
          f"{GEMMA2_TRAIN_CONFIG} train step {GEMMA2_TRAIN_ROWS}x"
          f"{GEMMA2_TRAIN_SEQ} (remat) {g2['train']['timings']['step_ms']:.1f}"
          f" ms ({g2['train']['timings']['tokens_per_s']:.0f} tokens/s, the "
          f"flash backward {g2_bwd['ms']:.1f} ms of it); "
          + "; ".join(
              f"{n} train step {r}x{q} {tr[n]['timings']['step_ms']:.1f} ms "
              f"({tr[n]['timings']['tokens_per_s']:.0f} tokens/s, "
              f"{tr[n]['timings']['mfu']:.4f} of peak)"
              for n, r, q in ((hcfg.name, HYBRID_TRAIN_ROWS, HYBRID_TRAIN_SEQ),
                              (xcfg.name, XLSTM_TRAIN_ROWS, XLSTM_TRAIN_SEQ)))
          + f" ({XLSTM_TRAIN_LAYERS} layers)"
          + f"; launcher step {la['launcher_step_ms']:.1f} ms (plain "
          f"trainer {la['plain_step_ms']:.1f} ms); {MOE_LAUNCH_CONFIG} "
          f"launcher step " + ", ".join(
              f"{p} {ms:.1f} ms" for p, ms in
              la["moe_launcher"]["step_ms"].items())
          + f" (plain trainer {la['moe_launcher']['plain_step_ms']:.1f} ms)"
          + f"; script "
          f"{time.perf_counter() - T0:.0f} s")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
