"""Drive the PyTorch/CUDA port of hulc on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--steps 35] [--lanes 64] [--train-steps 5]

Run from the repository root. Phases, each of which exits non-zero when
it fails:

1. device: requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit`` gives them. TF32 is turned
   off for cuDNN convolutions and cuBLAS matmuls: the port computes in
   fp32, and TF32 convolutions would break parity with the plain path.
2. build: compiles ``hulc_tpu_torch/csrc/*.cu`` for sm_90a (kernels.build).
3. kernels: each serving kernel against its plain PyTorch version at the
   policy's shapes, one lane and ``--lanes`` lanes (the eval preprocess
   bit-equal for both cameras; the SpatialSoftmax forward, here and below,
   with a fixed and with a learnable temperature; the action sampler (B.3)
   at K = 10 and 17 from raw draws and from injected uniforms, which must
   give the same action bit for bit, the gripper column bit-equal with
   ties in the gripper logits, identical picks at u_inv = 0.5, also with
   NaN scores and NaN gripper logits, as torch.argmax picks); each training kernel
   against its plain version (its backward against autograd through the
   plain forward) at the training step's shapes, the SpatialSoftmax
   forward and backward with a fixed and with a learnable temperature (a
   CUDA tensor, whose gradient the backward gives too). Then
   ``hulc_debug``: the shift, the eval preprocess and the SpatialSoftmax
   forward and backward at its shapes and at odd ones (an unaligned frame,
   widths that are not a multiple of 4, a row count that is not a multiple
   of 8). The mixture NLL (B.3') at the step's, at
   ``hulc_debug``'s and at odd shapes (37 frames, A = 5, K = 7 and 33, with
   and without a gripper): the inputs must reach every branch (both edge
   bins, interior, density fallback, clamp active); the forward must keep
   its gradients for the backward under autograd and keep and allocate
   none under no_grad. The SpatialSoftmax kernels also on ``[1:]`` of the
   (5, 3, 7, 7) map, a view 12 bytes off 16-byte alignment. The decoder
   RNN's recurrence (B.6): the forward kernel against the plain loop, and
   the autograd Function's four gradients (backward kernel, dW product,
   bias sum) against the closed form and against autograd through the
   loop, each within REC_REL relative L2, at the train step's (64, 32,
   2048) through both layers, one, eight and 64 serving lanes (S = 1,
   nonzero carry: the one-step GEMV launch up to eight rows, a one-step
   cluster launch above), 96 rows (two row tiles) at (96, 3, 2048),
   ``hulc_debug``'s H = 64, an odd (3, 5, 37) and a tiny (3, 5, 5). Adam
   (B.5) bit-equal to its plain version over two steps on the model's
   parameters and at numel 1, 3, 4, 5, 16,383, 16,385 and 4,194,304, a
   parameter without a gradient, a view of all four arrays and 500 small
   tensors (two launches), and the wrapper refuses a p view 4 bytes off
   its moments' 16-byte phase; the
   gradient norm (B.7) the same pass
   gives: its block partials within PARTIALS_RTOL of the plain sums of
   their ranges and bit-equal on a second launch, the finish launch
   bit-equal to its plain mirror, the norm within GRAD_NORM_RTOL of an
   fp64 sum and of the plain ``global_norm``. The plan sample and balanced
   KL (B.4) from both noise entries (uniforms, transformed in the kernel,
   and their Gumbel noise) at the step's (64, 32, 32), ``hulc_debug``'s
   (6, 4, 4), odd (3, 5, 7), (3, 2, 64), (2, 3, 70), (2, 40, 8) and a view
   of (64, 32, 32) 4 bytes off alignment: identical picks, the sample
   within 1's ulp, the KL rtol 1e-5, gradients 1e-5 relative L2; one
   generator seed picks the same classes through the kernel path and the
   plain path; with NaN in the Gumbel noise the picks are torch.argmax's;
   the in-kernel Gumbel transform is ``gumbel_noise``'s bit for bit
   (``check_gumbel_bits``).
4. serving main path, single lane: the full-width ``hulc`` HulcPolicy
   (random weights from ``--seed``, synthetic uint8 frames, 15-d
   robot_obs, 384-d language embedding) for ``--steps`` steps, across the
   replan at replan_freq=30.
5. serving main path, batched: BatchedHulcPolicy with ``--lanes`` lanes
   and staggered per-lane replans.
   Launch counts are zeroed just before phase 4 and read just after
   phase 5; every serving kernel, the recurrence's forward among them,
   must have launched.
6. serving plain path: the same steps through a model built with
   use_kernels=False on the card, fed each step the state the kernel path
   had and the same noise (same generator seed); the actions must agree.
7. serving timing: policy step times through the entry points, and each
   serving kernel against its plain version at ``--lanes`` lanes and at
   one lane (the preprocess for both cameras): device time (the CUDA
   activity torch.profiler records) and time per call (CUDA events around
   back-to-back calls, so the host's launch cost is included); the action
   sampler (B.3) also by CUDA events with the host's launch cost kept out.
8. training main path: a full-width ``hulc`` Trainer (random init from
   ``--seed``) takes ``--train-steps`` steps on a synthetic loader-fused
   uint8 batch (32 vision + 32 language windows of 32 frames). Launch
   counts are zeroed just before and read just after; every training
   kernel must have launched and every loss must be finite. Step time:
   median after two warm-up steps, CUDA events and the host clock.
9. training plain path: one step from the same params, batch, shifts and
   plan noise through use_kernels=False (recognition dropout 0 in both
   runs, cuDNN deterministic); every loss (``grad_norm`` among them, from
   the Adam pass against the plain ``global_norm``) and every gradient
   must agree. Then the same with a learnable SpatialSoftmax temperature,
   set to 0.7.
10. training timing: each training kernel against its plain version at
   the step's shapes (the SpatialSoftmax forward, the backward also with a
   learnable temperature, the mixture NLL forward also under no_grad), its bound and
   its share of the bound; the optimizer tail (Adam with the norm's
   partials and the finish launch) against the plain tail (the eager norm,
   then the plain update) and the library's (``get_total_norm`` and fused
   fp32 Adam); the finish launch (B.7) against a plain sum of its
   partials, its bound its own bytes, and beside it the whole norm's
   bound, the eager norm and ``get_total_norm``; the recurrence's kernels at the step's shape (the forward
   also at 1 and 64 lanes, the backward also with the dW product and the
   bias sum) against the plain loop and cuDNN's relu RNN (W_ih = I) as
   the library yardstick, all by CUDA events (the profiler drops some of
   the cooperative launches), with each launch's plan; the device time of an empty launch (``csrc/launch_floor.cu``),
   the floor under every kernel's; B.4's forward and backward also by CUDA
   events with the host's launch cost kept out, and the backward also
   through a loss; each kernel's registers, shared memory and spills from
   the build log. (A kernel against its parent design, and each sampling
   tail against the parent's: ``evaluation/kernel_times.py --tree``.)
11. evaluator: the LH-MTLC protocol through the port's entry points
   (``evaluation/eval_split.py``). ``evaluate_policy_batched`` drives the
   full-width model's BatchedHulcPolicy at 64 lanes over 128
   feasibility-filtered chains (``chain_sampler.get_sequences``) with their
   matched resets, in interactive FakeCalvinEnvs at 200 px static and
   84 px gripper, ep_len 90 (three replans an instruction), 384-d task
   embeddings; then ``evaluate_policy`` drives HulcPolicy over 2 chains at
   ep_len 60. Launch counts are zeroed before and read after each run: the
   eval preprocess (both cameras), the SpatialSoftmax forward, the action
   sampler and the recurrence's forward must have launched exactly as
   often as the policy steps (and, sequentially, the replans) imply, and
   nothing else. results.json must have its schema and count every chain
   once. Every lockstep iteration, as recorded (frames, embeddings, state,
   replan mask), is replayed through the plain path on the card with the
   same generator seed, so the replans inside an instruction and at a
   lane's next chain are held too; the actions must agree as in phase 6.
   Prints env-steps/s, wall seconds, policy steps and the wall time split
   between the policy step and the envs, oracle and loop (host clock);
   then one round of lanes (64 chains, ep_len 30) under torch.profiler
   gives the device's idle share of an evaluator run.

12. training loop: ``Trainer.fit`` through the port's entry points at full
   width. A fixture dataset (``data.fixtures``, 200 / 84 px, 4 training
   episodes of 64 frames and 2 validation episodes) is written to a
   temporary directory; ``make_loaders`` (batch 32 per modality, fused for
   training, per modality and deterministic for validation) feeds ``fit``
   for 2 epochs of 3 steps, validation capped at 2 batches an epoch,
   checkpoints in a temporary run dir; a new Trainer resumes from the last
   checkpoint for 1 step. Launch counts are zeroed before and read after:
   every train-step kernel must have launched, and validation exactly the
   kernels its steps imply (B.1 at the window shape, B.3 over whole
   windows, B.3' forward without its backward, B.6 forward under no_grad)
   and nothing else. metrics.jsonl must hold train, val and epoch lines,
   all finite, the val lines with the JAX package's keys (``VAL_KEYS``);
   the last checkpoint must restore the parameters, the Adam state, the
   step and the generator bit-equal. One val step is held against the
   same weights' use_kernels=False model on the same plan and sampler
   noise (near ties pulled apart and counted): losses and MAEs within
   VAL_REL, gripper success rates and sampled plans equal; on that step's
   own inputs, at its window shapes, B.6's forward is held against the
   plain loop (REC_REL, per decoder layer), B.3 against the plain sampler
   (atol 1e-5, the gripper column bit-equal, the same picks) and B.3''s
   forward under no_grad against the plain NLL (LOSS_RTOL). B.1 at the
   window shape is bit-equal to its plain version and timed against its
   bytes. Four fused batches uploaded back to back through the trainer's
   two staging slots, queued behind a spin of the copy stream, must arrive
   byte-equal to their host batches. Prints the host's core count, the host loader's ms per batch,
   the upload's ms (into pinned memory, and the copy on the side stream),
   the val step's ms, fit's epochs, the loop's seq/s over longer epochs
   with one and four assembly workers beside the device-resident step
   (phase 8), and, under torch.profiler, the device's idle share of the
   loop.

13. serving export: ``serving.export_policy`` writes the full-width
   ``hulc`` policy (``--seed`` weights, ``--lanes`` lanes) as
   ``torch.export`` programs on the card, and a ``hulc_debug`` policy
   exported on the CPU. A fresh process (``--serve-child``) that imports
   only the serving runtime (it fails if a model, evaluator, trainer,
   config or data module of the port, or JAX, was loaded) serves them:
   ``ServedPolicy`` over phase 4's ``--steps`` language-goal steps, a
   ``reset()`` and a visual-goal episode; ``ServedBatchedPolicy`` over
   phase 5's lockstep steps; the ``hulc_debug`` artifact, moved to the
   card, over a few steps. Observations go to it, and actions and each
   step's launches come back, as files. The actions must agree with the
   live ``HulcPolicy`` / ``BatchedHulcPolicy`` from the same seed on the
   same observations bit for bit, every served step must launch exactly
   what the live step launches, the four serving kernels must launch and
   no other (``run_serving_export``, which phases 14, 16, 17 and 21 call
   for their artifacts too: one child serves all of a call's). Prints
   the export's seconds, the artifact's bytes, the served and live
   step's host ms at 1 and ``--lanes`` lanes, and each serving op's host
   microseconds per call through the dispatcher beside its kernel
   function's called directly (``dispatch_us``).

14. mcil: the ``mcil`` preset at full width (``--seed`` weights): the BiRNN
   plan recognition's kernels, the tanh recurrence (B.8: forward, dh chain,
   and the autograd Function's four gradients, with a nonzero carry and a
   carry gradient, on each layer's W_hh) and the bidirectional layer (B.9:
   both chains into one (B, S, 2H) output, forward, backward kernels and
   the Function's seven gradients) against their plain versions within
   REC_REL at the train step's (64, 32, 2048), through both layers (layer 0
   from 128 features, layer 1 from 4096), and B.9 at (3, 5, 37), one step
   (3, 1, 37) and two row tiles (96, 3, 64); both timed by CUDA events
   beside their plain versions and cuDNN's tanh RNN (W_ih = I; the
   bidirectional one for B.9). Then the main path, launch counts zeroed
   just before and read just after: ``--train-steps`` train steps at 2B =
   64, S = 32 (each launches B.8 four times and B.9 twice, forward and
   backward), a val step, the single-lane policy over 35 steps (replans at
   0 and 30, a ``reset()``, a replan), the lockstep policy at ``--lanes``
   lanes over 35 steps, and ``evaluate_policy_batched`` at ``--lanes`` lanes
   over 64 chains at ep_len 30; B.1, B.2, B.3, B.3', B.6, B.8 and B.9 must
   have launched, and B.4 not (the continuous plan is eager). The main
   path is then held against ``use_kernels=False``: one train step (losses
   and gradients as in phase 9), one val step (as in phase 12, the
   continuous plans within VAL_REL), the policies' actions within
   ACTION_ATOL; and the policy is exported at ``--lanes`` lanes and served
   bit-equal with the same launches per step (as in phase 13).

15. hulc_depth: the RGB-D preset at full width (``--seed`` weights, JAX's
   50,293,559 parameters): the depth noise (B.10) at the train step's
   shapes (the static camera's gamma noise at (64, 32, 200, 200), the
   gripper's gaussian noise at (64, 32, 84, 84)). Its z mode against its
   plain version bit for bit, also written into the draw's buffer, and at
   945 elements 4 bytes off alignment. Its draw mode (the normals drawn in
   the launch): the Philox words bit-equal to numpy's, the frames bit-equal
   to the plain version on the normals it wrote, the normals within
   DRAW_Z_ATOL of the plain Box-Muller, their moments over the step's
   96.3 M draws, a two-rank split and a restored generator state bit-equal,
   two calls apart. Its device time beside its plain version's, its bound,
   ``torch.randn`` + the z mode (what the step ran before) and, for the
   gaussian mode, ``torch.randn`` + ``torch.add(x, z, alpha=0.01)``. Then
   the main path, launch counts zeroed just before and read just after:
   ``--train-steps`` train steps at 2B = 64, S = 32 on a device-resident
   batch with depth frames (each launches B.10 twice and B.2 / B.2' twice,
   for both static towers, and draws no ``torch.randn`` of a depth frame's
   shape), a val step (B.10 not at all), ``fit`` for 2 epochs of 2 steps on
   a 200 / 84 px fixture with depth frames (one loader worker, the
   DeviceLoader, validation and checkpoints) under torch.profiler for
   seq/s and the device's idle share, and a run cut and resumed bit-equal
   to an uninterrupted one. Then one train step against
   ``use_kernels=False`` on the same shifts, depth noise and plan noise (as
   in phase 9) and one val step (as in phase 12).

16. gated decoder cells: ``hulc`` at full width with
   ``action_decoder.rnn_cell`` set to gru and then to lstm by
   ``config.apply_overrides`` (``--seed`` weights; the decoder RNN 3x and
   4x the relu one's parameters). Each cell's forward (B.11, B.12: the
   inference launch, saving nothing, and the training launch, saving the
   gates) and dh chain against their plain versions within REC_REL
   (relative L2), and the autograd Function's gradients against the
   closed form and against autograd through the plain loop, from a nonzero
   carry (lstm's h and c) with nonzero carry cotangents, at the train
   step's (64, 32, 2048) on both decoder layers' W_hh, at (3, 5, 37), two
   row tiles (96, 3, 64) and one step at 1 and 64 lanes; their times by
   CUDA events beside the plain loop, cuDNN's nn.GRU / nn.LSTM of the same
   weights (W_ih = I, forward and forward + backward) and the bound. Then
   the main path, launch counts zeroed just before and read just after:
   3 train steps (each layer's forward and dh chain once a step, the relu
   kernels never), a val step (4 forwards a layer), a single-lane policy
   over 4 steps with a reset and the lockstep policy at ``--lanes`` lanes
   over 3 steps with replans on some lanes (one forward a layer a step);
   the train step's ms and peak memory beside ``hulc``'s (phase 8). Then
   one train step (as in phase 9), one val step (as in phase 12) and the
   policies' actions (ACTION_ATOL) against the plain path; and the lstm
   policy exported at ``--lanes`` lanes and served bit-equal with the same
   launches per step (as in phase 13).
17. bf16: ``hulc`` with ``compute_dtype=bfloat16`` through
   ``config.apply_overrides`` (fp32 parameters; convolutions and matmuls in
   bf16 as the JAX package's ``dtype=`` puts them). The bf16 instances of
   B.1 (the val window shape), B.1' (the step's), B.2 (the step's bf16 map,
   its first 64 rows and its first row, T fixed and learnable) and B.2' /
   B.2'' against their plain versions (B.1, B.1' bit-equal; B.2 within
   SS_FWD_RTOL / SS_FWD_ATOL; each B.2' dx entry within one bf16 ulp, the
   whole within BF16_DX_REL, dT within SS_DTEMP_RTOL) and against the fp32
   instances on the same values (bit-equal: they compute in fp32 in the
   fp32 instances' order and round once), timed beside them. Then the main
   path, launch counts zeroed just before and read just after: ``--train-
   steps`` train steps (B.1' bf16 twice, B.2 and B.2' bf16 once a step, the
   fp32 instances never), a val step (B.1 bf16 four times, B.2 twice), a
   single-lane policy over 4 steps with a reset and the lockstep policy at
   ``--lanes`` lanes over 3 steps (serving preprocesses to fp32, as JAX's
   policies do; B.2 reads the bf16 map); the train step's ms and peak
   memory beside phase 8's fp32 step. Then one train step, one val step
   and the policies' actions against the plain path: each loss, gradient,
   val loss and MAE within its fp32 limit or NOISE_FACTOR x its own
   sensitivity to keypoint noise (the share of keypoints whose bf16
   rounding B.2's kernel moves, measured here, moved one bf16 ulp; with
   it, as in every bf16 plain-path check, the recurrence's outputs at
   B.6's own bf16 flip share and the plan KL's logit gradients one ulp,
   B.4's backward), success rates and plans equal; the lockstep actions within ACTION_ATOL, the
   single lane's within ACTION_ATOL or NOISE_FACTOR x its sensitivity to
   that keypoint noise together with noise at the decoder recurrence's own
   share (of its layer-0 outputs, which the next layer's bf16 input
   projection rounds, those the kernel rounds to another bf16 value than
   the plain loop on the same inputs, measured on these steps); and the
   policy exported at ``--lanes`` lanes and served bit-equal with the same
   launches per step.
18. the optimizers and the CLIs, ``hulc`` at full width: each instance of
   ``csrc/adam_lowp.cu``'s template (B.5's bf16 Adam, B.5''s fp32 Adam,
   AdamW and SGD) through its optimizer over 3 steps at the model's
   47,053,559 parameters (one tensor without a gradient) against the
   plain version from the same state: parameters and moments bit-equal,
   each norm within GRAD_NORM_RTOL; the B.5' instances timed beside their
   bound, plain versions and the fused ``torch.optim`` yardsticks. Then the
   main path, launch counts zeroed just before and read just after: the
   train CLI in-process (``training.train.main``) on a 200 / 84 px
   ``--fixture``: AdamW for 3 steps and a relaunch to 5 by
   ``--steps-total``, SGD for 3, fp32-moment Adam for 3 with the batched
   rollout callback (64 envs, 64 chains, ep_len 90; ``metrics.jsonl``
   must log ``eval_lh/avg_seq_len``), the default optimizer for 3 with
   ``profile_start=1, profile_steps=2`` (its trace must name every train
   kernel); the evaluate CLI batched over every checkpoint of the AdamW
   run and sequentially over 4 chains on the SGD run's last, each
   results.json in JAX's schema; a synthetic reference ``.ckpt`` (the
   model's state_dict at ``--seed`` + 7 and one buffer the port lacks)
   imported, its restored parameters bit-equal to the file's, and
   evaluated batched. Every kernel of these paths must launch.

19. the BiRNN's relu and gru cells (B.13), dropout and the encoders'
   options: ``mcil`` with ``plan_recognition.birnn_cell`` gru and then rnn,
   and dropout B13_DROPOUT at every site the JAX package has on that path
   (the BiRNN's and the decoder's between layers, both vision encoders'),
   set by ``config.apply_overrides``. Each cell's chain kernels, forward
   (the gru's saving its gates) and dh chain, against their plain mirrors
   for the forward and the reverse chain at (64, 32, 2048) on both layers'
   weights; one layer at a time through the autograd Function against
   ``birnn_layer_plain`` (the output, and the seven gradients against the
   closed form and autograd) there and at (3, 5, 37), (3, 1, 37), (96, 3,
   64), all within REC_REL; the chains timed by CUDA events beside their
   plain mirrors, cuDNN's nn.RNN(relu) / nn.GRU (W_ih = I) and the bound,
   and each layer beside cuDNN's bidirectional one. Then the main path,
   launch counts zeroed just before and read just after: B13_TRAIN_STEPS
   train steps (each layer's two chains once forward and once backward a
   step, no tanh kernel) and a val step; then one train step against the
   plain path on the same generator state (the same dropout masks;
   phase 9's rule). The train CLI for 3 steps on a 200 / 84 px
   ``--fixture`` with the gru BiRNN and the dropout sites by ``--set``.
   ``hulc`` with every encoder option on (OPTION_OVERRIDES): one train step
   and a policy step at 1 and ``--lanes`` lanes against the plain path.
   Last, the decoder's B.6 and B.11 on ``kernel_times.py``'s fixed inputs
   must give the digests of the tree before B.13 (PARENT_DIGESTS).
20. data-parallel and ZeRO-3 training, ``hulc`` at full width (fp32, TF32
   off, one global batch of 2B = 64 windows of 32 frames): the one-device
   ``Trainer``'s 3 steps here; the train CLI under ``torchrun --fsdp``
   (``torch.distributed.run --standalone``) for 3 steps on a 200 / 84 px
   ``--fixture``, its rank 0's checkpoint restored here in one process
   without a group for one more step; then ``torch.cuda.device_count()``
   ranks (at most 4) over NCCL (``parallel.mesh.Ranks``), each on its
   rows of the batch: 3 DistributedDataParallel steps (on at one rank
   too, ``data_parallel=True``) and 3 FSDP2 steps, launch counts zeroed
   just before and read just after in every rank (the training kernels
   must launch in each), each step's ``total_loss`` and ``grad_norm`` and
   every parameter after step 3 within PARALLEL_REL relative L2 of the
   one-device run (bit-equality printed; cuDNN's deterministic algorithms
   in every process; an attention's key bias on its query and value
   thirds, ``against``); then the FSDP trainer restores
   the CLI's checkpoint and takes the step the one process took, held to
   it the same way. Then PARALLEL_TIMED_STEPS more steps of each on cuDNN's
   default algorithms, the batch on the device as in phase 8: their times
   (host clock) beside the one-device step's,
   the gradient shards the optimizer copied to their parameter's phase and
   what the copies cost, and the ``hulc_depth`` step's depth noise on one
   of two ranks (B.10 draws only the rank's rows). With one card the equal-loss check of N
   ranks against one is reported as needing a second card.
21. GCBC, the deterministic decoder, the state-only family and hulc's
   auxiliary losses at full width (``--seed`` weights, JAX's parameter
   counts, VARIANT_PARAMS; GCBC has no plan proposal). First B.1', B.2 and
   B.2' against their plain versions at ``fetch_vision``'s shapes (its
   84 px static camera at the train step's frames, pad 4, and the 7 x 7
   map its tower gives). Then for ``gcbc``, ``hulc_deterministic`` (relu
   RNN), ``hulc_deterministic`` with ``action_decoder.rnn_cell=mlp`` and
   ``hulc_state_only`` the main path, launch counts zeroed just before and
   read just after: VARIANT_TRAIN_STEPS train steps, each kernel's launches
   per step exactly ``variant_step_launches`` (B.1' per camera, B.2 / B.2'
   per SpatialSoftmax camera, B.3' with the logistic decoder, B.4 with a
   discrete plan, B.6 with the relu cell, B.5 and B.7; every other kernel
   0), a val step, the policy at 1 and ``--lanes`` lanes, for ``gcbc`` a
   short ``evaluate_policy_batched`` pass at ``--lanes`` lanes; over the
   whole path every kernel of ``variant_path_kernels`` launched and no
   other; the train step's ms by host clock and CUDA events. Then one
   train step (as in phase 9), one val step (as in phase 12) and the policies' actions
   (ACTION_ATOL) against the plain path. ``fetch_state``, ``fetch_vision``
   and ``hulc`` with state reconstruction, BC-Z and MIA on (AUX_OVERRIDES):
   one train step (its launches exact, the auxiliary losses positive) and
   one policy step, each against the plain path. Last, ``gcbc`` and the
   ``mlp`` decoder exported at ``--lanes`` lanes and served by one process
   without model code (``run_serving_export``), bit-equal with the same
   launches per step.
22. the frozen CLIP and tactile encoders at full width (JAX's parameter
   counts, ENCODER_PARAMS). First B.15 (``csrc/resize_preprocess.cu``)
   against its plain version in every mode (the CLIP and tactile
   branches, training and evaluation, fp32 and bf16 out, a 160 x 120
   tactile frame's one launch and the raw resize, a resized CNN camera) at the training
   step's and validation's frames: each output within the plain epilogue
   of the plain resize -+ B15_TOL pixel values, the share that rounds to
   another bf16 value at most B15_FLIP_SHARE; its times beside
   ``F.interpolate(antialias=True)`` of the resize alone. Then for
   ``hulc_clip_vision`` (RN50, fp32 and bf16; ViT-B/32 a train step
   alone), ``hulc_tactile`` (CALVIN's 160 x 120 x 6 frames) and
   ``hulc_clip_lang`` the main path, launch counts zeroed just before and
   read just after: ENCODER_TRAIN_STEPS fused train steps, each kernel's
   launches per step exactly ``encoder_step_launches`` (B.15 once for a
   CLIP camera and once for a tactile tower, 0 for ``hulc_clip_lang``),
   a ``{vis, lang}`` step, the frozen backbones' gradients zero tensors,
   a val step, for ``hulc_clip_lang`` the policy at 1 and ``--lanes``
   lanes and a short ``evaluate_policy_batched`` pass; then one train
   step (ENCODER_PATTERNS noise patterns for the long towers; the bf16
   model's noise as phase 17's) and one val step against the plain path, and
   ``hulc_clip_lang``'s policies (ACTION_ATOL). ``hulc_clip_vision``'s
   ``fit`` on a 200 / 84 px fixture and ``train.py --config
   hulc_clip_vision --fixture``; ``hulc_clip_lang``'s export served by one
   process without model code, bit-equal; last, ``hulc_clip_lang``'s train
   step timed beside ``hulc``'s, in turn in this process
   (``time_beside_hulc``).

Prints a ``{"kernels": [...]}`` JSON line (launches on the serving,
training, evaluator, training-loop, served, mcil, hulc_depth, gated
decoder, bf16, CLI, B.13, data-parallel (summed over the ranks), variant
and encoder paths) and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): device memory rate and
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

ACTION_ATOL = 1e-4  # kernel path vs plain path, per action entry
# the kernels a policy step launches (B.1, B.2, B.3, B.6's forward)
SERVING_KERNELS = ("hulc_preprocess_rgb", "hulc_spatial_softmax", "hulc_logistic_mixture_sample", "hulc_rnn_relu_fwd")
PLAN_TIE_BUDGET = 1e-3  # share of replanned plan categories allowed to differ

# Training tolerances, kernel against plain version on the same inputs:
# fp32 sums taken in another order, so relative errors of a few ulp; each
# backward kernel's gradient is held, as a whole tensor, to its norm
# (relative L2), since an entry that sums terms of both signs can lose its
# relative precision while the tensor keeps it.
SS_FWD_RTOL, SS_FWD_ATOL = 1e-5, 1e-6  # SpatialSoftmax keypoints, per entry (reduction order)
SS_BWD_RTOL, SS_BWD_ATOL = 1e-5, 1e-7  # SpatialSoftmax dx, per entry
SS_DTEMP_RTOL = 1e-5  # SpatialSoftmax temperature gradient, relative (a sum over the whole map)
LOSS_RTOL = 1e-5  # mixture NLL and plan KL forward, per entry
GRAD_REL = 1e-5  # backward kernels, relative L2 per gradient tensor
ONE_ULP = 2.0**-23  # the straight-through value (1 + p) - p rounds at 1's ulp
STEP_LOSS_RTOL = 1e-5  # train step, kernel path vs plain path, per loss key
STEP_GRAD_REL = 1e-4  # train step, relative L2 per parameter's gradient, or:
NOISE_FACTOR = 2.0  # times the step's measured sensitivity (compare_train_plain)
# random one-ulp patterns the sensitivity is the largest change over
# (compare_train_plain): about one pattern in five switches the mcil step's
# most sensitive relu unit (2 of 10 measured), and 16 patterns all miss it
# with a chance of 0.8^16, about 3%
ULP_PATTERNS = 16
PLAN_TIE_MARGIN = 1e-3  # plan noise margin that float noise cannot cross (separate_plan_ties)
ZERO_GRAD = 1e-7  # share of the gradient's norm below which a leaf's is rounding noise
# B.7, the global gradient norm: fp64 partial sums of exact squares, so
# within a few fp32 roundings of an fp64 sum; the plain fp32 global_norm
# chains 106 fp32 sums, each within about 1e-7
GRAD_NORM_RTOL = 1e-6
PARTIALS_RTOL = 1e-12  # each block's fp64 sum against the plain fp64 sum of its range (another order)
# B.6, the recurrence: y and each gradient against the plain version, as
# whole tensors (fp32 sums in another order through up to 32 relu steps; a
# unit within rounding of relu's edge may switch, so not per entry)
REC_REL = 1e-5
DECODER_ROWS, DECODER_SEQ = 64, 32  # the train step's decoder input: 2B = 64 windows of S = 32 frames


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time per call of ``iters``
    back-to-back calls, from CUDA events, after a warm-up: the rate at
    which the host issues the calls when it is slower than the device."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


PROFILE_ATTEMPTS = 3  # a window whose every launch must be recorded is profiled at most this often


def device_ms(fn, iters: int, launches_per_call: int | None = None, per_recorded: bool = False) -> float:
    """Device time per call: the CUDA activity torch.profiler records over
    ``iters`` calls (every kernel the call launches), after a warm-up. With
    ``launches_per_call``, the time of a window in which the profiler
    recorded every launch: a window that lost some (now and then the
    profiler drops one, e.g. one of the empty kernel's 100) is profiled
    again, and it fails if PROFILE_ATTEMPTS windows all lost launches or
    one recorded more, unless every window lost only its first launch of
    one a call (then the time is per recorded launch); with
    ``per_recorded`` too, the
    time is per recorded call instead (the profiler drops some launches of
    the short cooperative kernels)."""
    from hulc_tpu_torch.evaluation.profile_policy import profile_calls

    name = getattr(fn, "__qualname__", repr(fn))
    held = launches_per_call is not None and not per_recorded  # a window that must record every launch
    first_only = True  # every window lost its first launch and no other
    with tempfile.TemporaryDirectory() as tmp:
        trace = pathlib.Path(tmp) / "window.json" if held else None
        for _ in range(PROFILE_ATTEMPTS):
            _, ms, device = profile_calls(fn, iters, trace)
            if not ms > 0:
                fail(f"the profiler recorded no device time for {name}")
            recorded = sum(e.count for e in device)
            if per_recorded and launches_per_call:
                if recorded < launches_per_call * iters:
                    print(f"[timing] the profiler recorded {recorded} of {launches_per_call * iters} launches of "
                          f"{name}; its time is per recorded launch")
                return ms * iters * launches_per_call / recorded
            if launches_per_call is None or recorded == launches_per_call * iters:
                return ms
            if recorded > launches_per_call * iters:
                first_only = False
                break
            places, where = lost_launches(trace)
            first_only = first_only and places == [0]
            print(f"[timing] the profiler recorded {recorded} of {launches_per_call * iters} launches of {name} "
                  f"({where}); profiling the window again")
    if first_only and launches_per_call == 1:
        # every window dropped only its first launch's kernel record, window after window in one process
        # (seen on the parent tree too, on a card whose other processes kept every launch): the time per
        # recorded launch is the time per call
        print(f"[timing] every window of {name} lost only its first launch; its time is per recorded launch")
        return ms * iters / recorded
    fail(f"the profiler recorded {recorded} of {launches_per_call * iters} launches of {name}")


def lost_launches(trace_path):
    """Which kernel launches of a profiled window (its Chrome trace) have no
    kernel in it: (their places among the window's launches, in host order;
    a line with those and how far each kept kernel started after its launch
    as the trace maps the device's clock onto the host's)."""
    events = json.loads(pathlib.Path(trace_path).read_text())["traceEvents"]
    kernels_ = {e["args"].get("correlation"): e for e in events if e.get("cat") == "kernel" and "args" in e}
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", "")),
                      key=lambda e: e["ts"])
    lost = [i for i, e in enumerate(launches) if e.get("args", {}).get("correlation") not in kernels_]
    lags = [kernels_[e["args"]["correlation"]]["ts"] - e["ts"] for e in launches
            if e.get("args", {}).get("correlation") in kernels_]
    lag = f"{min(lags):.1f} .. {max(lags):.1f} us" if lags else "none kept"
    return lost, (f"{len(launches)} launches and {len(kernels_)} kernels in the trace; launches without a kernel "
                  f"at places {lost}; a kernel's start less its launch's {lag}")


def host_ms(fn, iters: int) -> float:
    """Median host-clock time of ``fn`` (which ends in a device sync)."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().double() - b.detach().double()).abs().max())


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def bound(nbytes: float, flops: float):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# synthetic observations
# --------------------------------------------------------------------------


def make_obs(rng, cfg, n):
    """``n`` env observations of the config's cameras (and scene state where
    its proprio reads it)."""
    pe = cfg.perceptual_encoder
    cams = [(k, getattr(pe, k).input_size) for k in ("rgb_static", "rgb_gripper") if getattr(pe, k) is not None]
    scene = pe.proprio is not None and pe.proprio.include_scene
    out = []
    for _ in range(n):
        robot_obs = rng.normal(size=15).astype(np.float32)
        robot_obs[3:6] = rng.uniform(-1.0, 1.0, 3)
        obs = {"rgb_obs": {k: rng.integers(0, 256, (px, px, 3), np.uint8) for k, px in cams}, "robot_obs": robot_obs}
        if scene:
            obs["scene_obs"] = rng.normal(size=24).astype(np.float32)
        out.append(obs)
    return out


def replan_mask(t: int, lanes: int, freq: int) -> np.ndarray:
    """Every lane plans at t=0, then each lane every ``freq`` steps with a
    per-lane phase, so replans are staggered across steps."""
    return np.array([t == 0 or (t + lane) % freq == 0 for lane in range(lanes)])


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def check_preprocess(imgs, where):
    """B.1: bit-equal to the plain version (both normalize as the CPU does)."""
    from hulc_tpu_torch.ops.image_ops import preprocess_rgb_seq, preprocess_rgb_seq_plain

    got, want = preprocess_rgb_seq(imgs), preprocess_rgb_seq_plain(imgs)
    if got.shape != want.shape or not torch.equal(got, want):
        fail(f"preprocess kernel at {where} {tuple(imgs.shape)} is not bit-equal: max abs err {max_abs(got, want)}")


def check_ss_fwd(conv_map, where):
    """B.2 on ``conv_map`` against the plain version at a fixed T = 1 and a
    learnable T = 0.7 (a CUDA tensor), within SS_FWD_RTOL / SS_FWD_ATOL;
    returns the largest absolute error."""
    from hulc_tpu_torch.models.vision import spatial_softmax, spatial_softmax_plain

    err = 0.0
    for temp in (1.0, torch.tensor([0.7], device=conv_map.device)):
        got, want = spatial_softmax(conv_map, temp), spatial_softmax_plain(conv_map, temp)
        if not torch.allclose(got, want, rtol=SS_FWD_RTOL, atol=SS_FWD_ATOL):
            fail(f"spatial_softmax kernel at {where} {tuple(conv_map.shape)}, T = {float(temp)}: "
                 f"max abs err {max_abs(got, want)}")
        err = max(err, max_abs(got, want))
    return err


def check_sampler(lead, a, k, gen, bounds):
    """B.3 at (*lead, a, k): the fused sampler on raw draws (the map into
    (U_MIN, U_MAX) in the kernel) against its plain version, the sample
    within atol 1e-5 and the gripper column bit-equal (every third frame's
    gripper logits tied: argmax's first index, the closed bound). On the
    same draws mapped by ``map_uniforms`` and passed with the identity map
    (injected noise) the whole action is bit-equal to the raw entry's: the
    kernel maps as the plain version does. With u_inv = 0.5 the inverse CDF
    term is exactly 0, so each sample IS the picked component's mean: equal
    samples = identical picks; also with NaN scores (torch.argmax picks the
    first NaN) and NaN gripper logits. Returns the largest absolute
    error."""
    from hulc_tpu_torch.ops.logistic_mixture import draw_raw_uniforms, map_uniforms, sample_action, sample_action_plain

    dev = gen.device
    shape = (*lead, a, k)
    logits, means = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
    params = (logits, torch.clamp_min(torch.randn(shape, generator=gen, device=dev) - 2.0, -7.0), means)
    grip = torch.randn((*lead, 2), generator=gen, device=dev)
    grip.view(-1, 2)[::3, 1] = grip.view(-1, 2)[::3, 0]
    raw = draw_raw_uniforms(shape, gen, dev)
    got = sample_action(*params, *raw, grip, bounds)
    want = sample_action_plain(*params, *raw, grip, bounds)
    if got.shape != (*lead, a + 1) or not torch.equal(got[..., a], want[..., a]):
        fail(f"mixture sample kernel at {shape}: gripper column {got[..., a]} against {want[..., a]}")
    if not torch.allclose(got, want, rtol=0, atol=1e-5):
        fail(f"mixture sample kernel at {shape}: max abs err {max_abs(got, want)}")
    mapped = [map_uniforms(u) for u in raw]
    if not torch.equal(sample_action(*params, *mapped, grip, bounds, (0.0, 1.0)), got):
        fail(f"mixture sample kernel at {shape}: injected uniforms give another action than the raw draws")
    if not torch.equal(sample_action(*params, *mapped, None, bounds, (0.0, 1.0)), got[..., :a]):
        fail(f"mixture sample kernel at {shape}: the sample without a gripper differs")
    half = torch.full_like(raw[1], 0.5)
    got_h = sample_action(*params, mapped[0], half, grip, bounds, (0.0, 1.0))
    if not torch.equal(got_h, sample_action_plain(*params, mapped[0], half, grip, bounds, (0.0, 1.0))):
        fail(f"mixture sample kernel picked other components than the plain version at {shape}")
    # NaN scores: two NaN components in every other row, one in every fourth; one NaN
    # gripper logit in every other frame, at index 0 and at index 1 in turns
    nan_logits, nan_grip = logits.clone(), grip.clone()
    nan_logits.view(-1, k)[::2, k // 2] = nan_logits.view(-1, k)[::2, k - 1] = float("nan")
    nan_logits.view(-1, k)[1::4, 1] = float("nan")
    nan_grip.view(-1, 2)[::4, 0] = nan_grip.view(-1, 2)[2::4, 1] = float("nan")
    nan_params = (nan_logits, *params[1:])
    for _ in range(3):  # the pick must not depend on which lane runs first
        got_n = sample_action(*nan_params, mapped[0], half, nan_grip, bounds, (0.0, 1.0))
        if not torch.equal(got_n, sample_action_plain(*nan_params, mapped[0], half, nan_grip, bounds, (0.0, 1.0))):
            fail(f"mixture sample kernel picked other components than torch.argmax with NaN scores at {shape}")
    return max_abs(got, want)


def check_kernels(model, cfg, lane_counts, rng):
    from hulc_tpu_torch.ops.image_ops import preprocess_rgb_seq_plain

    dev = model.device
    pe, ad = cfg.perceptual_encoder, cfg.action_decoder
    errs = {"preprocess_rgb": 0.0, "spatial_softmax": 0.0, "logistic_mixture_sample": 0.0}
    gen = torch.Generator(device=dev).manual_seed(1)
    for e in lane_counts:
        for size in (pe.rgb_static.input_size, pe.rgb_gripper.input_size):
            check_preprocess(torch.as_tensor(rng.integers(0, 256, (e, 1, size, size, 3), np.uint8), device=dev),
                             f"{e} lane(s)")

        s = pe.rgb_static.input_size
        frames = preprocess_rgb_seq_plain(
            torch.as_tensor(rng.integers(0, 256, (e, 1, s, s, 3), np.uint8), device=dev)
        )[:, 0]
        with torch.no_grad():
            conv_map = model.perceptual_encoder.rgb_static_encoder.conv_model(frames).contiguous()
        errs["spatial_softmax"] = max(errs["spatial_softmax"], check_ss_fwd(conv_map, f"{e} lane(s)"))

        # the policy's K and K = 17 (one component a lane, then a lane loop)
        for k in (ad.n_mixtures, 17):
            errs["logistic_mixture_sample"] = max(errs["logistic_mixture_sample"], check_sampler(
                (e, 1), ad.out_features - 1, k, gen, (ad.act_min_bound[-1], ad.act_max_bound[-1])))
    print(f"[kernels] mixture sampler at {lane_counts} lanes, K = {ad.n_mixtures} and 17: raw and injected "
          f"uniforms give the same action bit for bit, the gripper column (ties included) bit-equal, the "
          f"same picks as the plain version (u_inv = 0.5)")
    return errs


# --------------------------------------------------------------------------
# phases 4-6: the policy, kernel path and plain path
# --------------------------------------------------------------------------


def drive_single(cfg, model, obs, lang, seed):
    """HulcPolicy.reset/step over ``obs``; returns (actions, pre-step states)."""
    from hulc_tpu_torch.evaluation.policy import HulcPolicy

    policy = HulcPolicy(cfg, model, seed=seed)
    policy.reset()
    actions, states = [], []
    for o in obs:
        states.append(policy._state)
        actions.append(policy.step(o, lang))
    states.append(policy._state)
    return np.stack(actions), states


def drive_batched(cfg, model, obs_steps, langs, seed):
    """BatchedHulcPolicy.step over ``obs_steps``; returns (actions, states)."""
    from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy

    lanes = len(langs)
    policy = BatchedHulcPolicy(cfg, model, lanes, seed=seed)
    state = policy.initial_state()
    actions, states = [], [state]
    for t, obs in enumerate(obs_steps):
        act, state = policy.step(obs, langs, state, replan_mask(t, lanes, cfg.replan_freq))
        actions.append(act)
        states.append(state)
    return np.stack(actions), states


def check_actions(name, actions, lanes, discrete_gripper=True):
    if actions.shape[-1] != 7 or not np.isfinite(actions).all():
        fail(f"{name}: actions not finite of shape (..., 7): {actions.shape}")
    if discrete_gripper and not set(np.unique(actions[..., 6])) <= {-1.0, 1.0}:
        fail(f"{name}: gripper actions outside {{-1, 1}}")
    grip = ", gripper in {-1, 1}" if discrete_gripper else " (the gripper sampled, continuous)"
    print(f"[{name}] {actions.shape[0]} steps x {lanes} lanes: actions finite, shape (7,){grip}")


def compare_plain(name, kern_actions, plain_actions, kern_plans, plain_plans, replanned, cfg, atol=ACTION_ATOL):
    """Actions must agree within ``atol`` (ACTION_ATOL). A plan category whose argmax
    differs is a tie within float noise of the static-camera encoder; the
    (step, lane) pairs it touches are counted and left out, and at most
    PLAN_TIE_BUDGET of the replanned categories may differ. A continuous
    plan has no ties: the replanned plans must agree within ACTION_ATOL.
    GCBC's plan is empty: the actions alone."""
    d = cfg.distribution
    if kern_plans.shape[-1] == 0:
        err = float(np.abs(kern_actions - plain_actions).max())
        if not err <= atol:
            fail(f"{name}: kernel and plain actions differ by {err}")
        print(f"[{name}] plain path on the card agrees: max abs action err {err:.3g} (atol {atol:.3g}); no plan")
        return err
    if d.kind == "continuous":
        plan_err = float(np.abs(kern_plans - plain_plans)[replanned].max())
        err = float(np.abs(kern_actions - plain_actions).max())
        if not (err <= atol and plan_err <= atol):
            fail(f"{name}: kernel and plain actions differ by {err}, replanned plans by {plan_err}")
        print(f"[{name}] plain path on the card agrees: max abs action err {err:.3g}, replanned plan err "
              f"{plan_err:.3g} (atol {atol:.3g})")
        return err
    grid = (d.category_size, d.class_size)
    k_idx = kern_plans.reshape(kern_plans.shape[:-1] + grid).argmax(-1)
    p_idx = plain_plans.reshape(plain_plans.shape[:-1] + grid).argmax(-1)
    differing = (k_idx != p_idx) & replanned[..., None]
    tie = differing.any(-1)
    n_replanned = int(replanned.sum()) * d.category_size
    if differing.sum() > max(1, PLAN_TIE_BUDGET * n_replanned):
        fail(f"{name}: {int(differing.sum())} of {n_replanned} replanned plan categories differ")
    err = np.abs(kern_actions - plain_actions)[~tie]
    if not err.max() <= atol:
        fail(f"{name}: kernel and plain actions differ by {err.max()}")
    print(f"[{name}] plain path on the card agrees: max abs action err {err.max():.3g} "
          f"(atol {atol:.3g}); plan ties {int(differing.sum())} of {n_replanned} categories")
    return float(err.max())


def plain_single(cfg, plain_model, obs, lang, seed, kern_states):
    """The single-lane steps through the plain model, each step from the
    kernel path's state; returns (actions, post-step plans)."""
    from hulc_tpu_torch.evaluation.policy import HulcPolicy

    policy = HulcPolicy(cfg, plain_model, seed=seed)
    actions, plans = [], []
    for t, o in enumerate(obs):
        policy._state = kern_states[t]
        actions.append(policy.step(o, lang))
        plans.append(policy._state.plan[0].cpu().numpy())
    return np.stack(actions), np.stack(plans)


def plain_batched(cfg, plain_model, steps, seed):
    """Lockstep steps through the plain model, each step an (obs_batch,
    lang_embs, state, replan_mask) with the kernel path's state, from one
    generator seed; returns (actions, post-step plans)."""
    from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy

    policy = BatchedHulcPolicy(cfg, plain_model, len(steps[0][3]), seed=seed)
    actions, plans = [], []
    for obs, langs, state, mask in steps:
        act, state = policy.step(obs, langs, state, mask)
        actions.append(act)
        plans.append(state[0].cpu().numpy())
    return np.stack(actions), np.stack(plans)


# --------------------------------------------------------------------------
# phase 7: timing
# --------------------------------------------------------------------------


def time_kernels(model, cfg, lanes, rng):
    """Per-launch ms of each kernel and of its plain version on the same
    inputs, at ``lanes`` lanes (the preprocess for both cameras); and the
    least time the card could take."""
    from hulc_tpu_torch.evaluation.kernel_times import event_ms
    from hulc_tpu_torch.models.vision import spatial_softmax, spatial_softmax_plain
    from hulc_tpu_torch.ops.image_ops import preprocess_rgb_seq, preprocess_rgb_seq_plain
    from hulc_tpu_torch.ops.logistic_mixture import draw_raw_uniforms, sample_action, sample_action_plain

    dev = model.device
    pe, ad = cfg.perceptual_encoder, cfg.action_decoder
    s, g = pe.rgb_static.input_size, pe.rgb_gripper.input_size
    imgs = torch.as_tensor(rng.integers(0, 256, (lanes, 1, s, s, 3), np.uint8), device=dev)
    grip = torch.as_tensor(rng.integers(0, 256, (lanes, 1, g, g, 3), np.uint8), device=dev)
    with torch.no_grad():
        conv_map = model.perceptual_encoder.rgb_static_encoder.conv_model(
            preprocess_rgb_seq_plain(imgs)[:, 0]
        ).contiguous()
    shape = (lanes, 1, ad.out_features - 1, ad.n_mixtures)
    gen = torch.Generator(device=dev).manual_seed(2)
    lp, ls, mu = (torch.randn(shape, generator=gen, device=dev) for _ in range(3))
    grip_logits = torch.randn((lanes, 1, 2), generator=gen, device=dev)
    raw = draw_raw_uniforms(shape, gen, dev)
    bounds = (ad.act_min_bound[-1], ad.act_max_bound[-1])

    n_px = imgs.numel()
    n_logits = conv_map.numel()
    rows = lp.numel() // ad.n_mixtures
    cases = {
        # u8 read once, fp32 written once; mul, sub, div per element
        "preprocess_rgb": (
            lambda: preprocess_rgb_seq(imgs), lambda: preprocess_rgb_seq_plain(imgs),
            bound(n_px * (1 + 4), 3 * n_px), tuple(imgs.shape),
        ),
        "preprocess_rgb_gripper": (
            lambda: preprocess_rgb_seq(grip), lambda: preprocess_rgb_seq_plain(grip),
            bound(grip.numel() * (1 + 4), 3 * grip.numel()), tuple(grip.shape),
        ),
        # fp32 map read once, (N, 2C) written once; ~9 flops per logit
        "spatial_softmax": (
            lambda: spatial_softmax(conv_map, 1.0), lambda: spatial_softmax_plain(conv_map, 1.0),
            bound(4 * n_logits + 4 * 2 * conv_map.shape[0] * conv_map.shape[1], 9 * n_logits),
            tuple(conv_map.shape),
        ),
        # four (…, A, K) fp32 inputs, u_inv, the gripper logits and the (…, A + 1)
        # action; ~6 operations per component (the map, two logs, the score) plus
        # ~8 per sample
        "logistic_mixture_sample": (
            lambda: sample_action(lp, ls, mu, *raw, grip_logits, bounds),
            lambda: sample_action_plain(lp, ls, mu, *raw, grip_logits, bounds),
            bound(4 * 4 * lp.numel() + 4 * rows + 8 * lanes + 4 * lanes * (shape[-2] + 1), 6 * lp.numel() + 8 * rows),
            tuple(shape),
        ),
    }
    out = {}
    for name, (kernel_fn, plain_fn, (bound_ms, bound_by), shp) in cases.items():
        # plain, kernel, kernel, plain: the same card, in turns
        ms = [device_ms(plain_fn, 100), device_ms(kernel_fn, 100),
              device_ms(kernel_fn, 100), device_ms(plain_fn, 100)]
        out[name] = {
            "ms": min(ms[1], ms[2]), "plain_ms": min(ms[0], ms[3]),
            "bound_ms": bound_ms, "bound_by": bound_by, "shape": list(shp),
            "call_ms": call_ms(kernel_fn, 100), "plain_call_ms": call_ms(plain_fn, 100),
        }
    out["logistic_mixture_sample"]["event_ms"] = event_ms(lambda: sample_action(lp, ls, mu, *raw, grip_logits, bounds))
    return out


def time_policy(cfg, model, rng, lanes):
    """Median ms per step through the entry points (host clock; includes
    the frames' host-to-device copy and the action's copy back)."""
    from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
    from hulc_tpu_torch.evaluation.policy import HulcPolicy

    lang = rng.normal(size=384).astype(np.float32)
    single_obs = make_obs(rng, cfg, 1)[0]
    obs = make_obs(rng, cfg, lanes)
    langs = rng.normal(size=(lanes, 384)).astype(np.float32)
    return policy_step_ms(HulcPolicy(cfg, model, seed=0), BatchedHulcPolicy(cfg, model, lanes, seed=0),
                          single_obs, lang, obs, langs)


def policy_step_ms(policy, batched, single_obs, lang, obs, langs):
    """Median host ms of a single-lane step that acts (planned once before)
    and of a lockstep step that replans no lane, through ``policy`` and
    ``batched`` (live or served: the same entry points)."""
    policy.reset()
    policy.step(single_obs, lang)  # plan once; the timed steps act
    policy.replan_freq = 10**9
    single_ms = host_ms(lambda: policy.step(single_obs, lang), 50)

    state = [batched.initial_state()]
    mask = np.zeros(len(obs), bool)

    def step():
        _, state[0] = batched.step(obs, langs, state[0], mask)

    return single_ms, host_ms(step, 30)


# --------------------------------------------------------------------------
# phase 11: the LH-MTLC evaluator
# --------------------------------------------------------------------------

# The batched, sequential and profiled runs take eval_split's sizes; every
# lockstep iteration of the batched run is replayed through the plain path.
PROTOCOL_CHAINS, PROTOCOL_EP_LEN = 1000, 360  # LH-MTLC


def encode_act_launches(cfg):
    """({symbol: launches} of encoding one frame, of one decoder act)."""
    pe = cfg.perceptual_encoder
    cams = [c for c in (pe.rgb_static, pe.rgb_gripper) if c is not None]
    encode = {"hulc_preprocess_rgb": len(cams),
              "hulc_spatial_softmax": sum(c.kind == "spatial_softmax" for c in cams)}
    act = {"hulc_logistic_mixture_sample": 1, "hulc_rnn_relu_fwd": cfg.action_decoder.num_layers}
    return encode, act


def check_eval_launches(name, launches, encodes, acts, cfg):
    """Every serving kernel launched exactly as often as ``encodes`` frame
    encodings and ``acts`` decoder steps imply, and no other kernel."""
    from hulc_tpu_torch import kernels

    encode, act = encode_act_launches(cfg)
    want = {k.symbol: 0 for k in kernels.ALL_KERNELS}
    for per, n in ((encode, encodes), (act, acts)):
        for symbol, count in per.items():
            want[symbol] += count * n
    if launches != want:
        fail(f"{name}: launches {launches} are not the {want} that {encodes} encodings and {acts} acts imply")
    if not all(launches[s] > 0 for s in (*encode, *act)):
        fail(f"{name}: a kernel of the serving path was never launched: {launches}")
    print(f"[evaluator] {name}: launches {', '.join(f'{k} {v}' for k, v in launches.items() if v)} = "
          f"{encodes} frame encodings x {encode} + {acts} acts x {act}")


def check_eval_results(name, results_path, stats, started):
    """results.json's schema, and every chain counted exactly once: each
    chain's reset once, successes and attempts consistent with the chains."""
    on_disk = json.loads(results_path.read_text())
    r = on_disk.get("0", {})
    if set(on_disk) != {"0"} or set(r) != {"avg_seq_len", "chain_sr", "task_sr", "task_info"}:
        fail(f"{name}: results.json keys {sorted(on_disk)} / {sorted(r)}")
    if set(r["chain_sr"]) != {"1", "2", "3", "4", "5"} or set(r["task_sr"]) != set(r["task_info"]):
        fail(f"{name}: results.json chain_sr {sorted(r['chain_sr'])}, task_sr and task_info disagree")
    n = stats["chains"]
    if sorted(started) != list(range(n)):
        fail(f"{name}: chains were started {len(started)} times, not each of {n} once")
    successes = sum(v["success"] for v in r["task_info"].values())
    attempts = sum(v["total"] for v in r["task_info"].values())
    complete = round(r["chain_sr"]["5"] * n)
    if round(r["avg_seq_len"] * n) != successes or attempts != n + successes - complete:
        fail(f"{name}: {successes} successes and {attempts} attempts do not add up over {n} chains "
             f"(avg_seq_len {r['avg_seq_len']}, {complete} complete)")
    print(f"[evaluator] {name}: results.json schema {{avg_seq_len, chain_sr{{1..5}}, task_sr, task_info}}; "
          f"each of {n} chains started once; {attempts} instructions attempted, {successes} succeeded")


def run_evaluator(cfg, model, seed, card):
    """Phase 11: the batched evaluator (kernel path, replayed through the
    plain path) and the sequential one, with launch counts, accounting and
    the wall-time split."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
    from hulc_tpu_torch.evaluation.eval_split import (
        CHAINS, EP_LEN, IDLE_EP_LEN, LANES, SEQ_CHAINS, SEQ_EP_LEN, device_idle_share, run_batched,
        run_sequential,
    )
    from hulc_tpu_torch.evaluation.expert import task_embeddings
    from hulc_tpu_torch.evaluation.policy import HulcPolicy
    from hulc_tpu_torch.models import make_model

    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp)
        policy = BatchedHulcPolicy(cfg, model, LANES, seed=seed)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        # an iteration takes at most one env step of a chain: CHAINS * EP_LEN
        # bounds the iterations, so every one is kept for the replay
        batched, timed, started = run_batched(cfg, policy, CHAINS, EP_LEN, seed, out / "batched",
                                              record=CHAINS * EP_LEN)
        torch.cuda.synchronize()
        batched_launches = {k.symbol: k.launches for k in kernels.ALL_KERNELS}
        single = HulcPolicy(cfg, model, lang_embeddings=task_embeddings(cfg.lang_dim), seed=seed)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        seq, seq_started = run_sequential(cfg, single, SEQ_CHAINS, SEQ_EP_LEN, seed, out / "sequential")
        torch.cuda.synchronize()
        seq_launches = {k.symbol: k.launches for k in kernels.ALL_KERNELS}
        iters = batched["lockstep_iters"]
        check_eval_launches("batched", batched_launches, iters, iters, cfg)
        check_eval_launches("sequential", seq_launches, seq["policy_steps"] + seq["replans"], seq["policy_steps"],
                            cfg)
        check_eval_results("batched", out / "batched" / "results.json", batched, started)
        check_eval_results("sequential", out / "sequential" / "results.json", seq, seq_started)
    if seq["env_steps"] != seq["policy_steps"]:
        fail(f"sequential: {seq['env_steps']} env steps for {seq['policy_steps']} policy steps")

    # the first iterations against the plain path on the card
    plain_model = make_model(cfg, model.device, seed=seed, use_kernels=False)
    plain_model.load_state_dict(model.state_dict())
    records = timed.records
    kern_actions = np.stack([r.actions for r in records])
    check_actions("evaluator", kern_actions, LANES)
    p_actions, p_plans = plain_batched(
        cfg, plain_model, [(r.obs_batch, r.lang_embs, r.state, r.replan_mask) for r in records], seed
    )
    k_plans = np.stack([r.new_state[0].cpu().numpy() for r in records])
    replanned = np.stack([r.replan_mask for r in records])
    if len(records) != batched["lockstep_iters"]:
        fail(f"evaluator: {len(records)} iterations recorded of {batched['lockstep_iters']}")
    batched["plain_max_abs_err"] = compare_plain(
        f"evaluator, all {len(records)} iterations ({int(replanned.any(axis=1).sum())} with a replan, "
        f"{int((replanned.any(axis=1) & ~replanned.all(axis=1)).sum())} of them on only some lanes)",
        kern_actions, p_actions, k_plans, p_plans, replanned, cfg,
    )
    del plain_model, records, timed

    # the device's idle share of a shorter batched run, under the profiler
    with tempfile.TemporaryDirectory() as tmp:
        idle = device_idle_share(cfg, BatchedHulcPolicy(cfg, model, LANES, seed=seed), LANES, IDLE_EP_LEN,
                                 seed, tmp)
    if not idle["device_busy_ms"] > 0:
        fail(f"the profiler recorded no device time in the evaluator's run: {idle}")
    print(f"[evaluator] under torch.profiler, {idle['lanes']} lanes, {idle['chains']} chains, ep_len "
          f"{idle['ep_len']}: {idle['lockstep_iters']} lockstep iterations in {idle['wall_ms']:.4f} ms wall, device "
          f"busy {idle['device_busy_ms']:.4f} ms, idle {100 * idle['idle_share']:.2f}% (policy step "
          f"{100 * idle['policy_share']:.2f}% of the wall under the profiler) ({card})")

    for name, st in (("batched", batched), ("sequential", seq)):
        lanes_txt = f"{st['lanes']} lanes, " if "lanes" in st else "1 lane, "
        steps = st.get("lockstep_iters", st.get("policy_steps"))
        print(f"[evaluator] {name}: {lanes_txt}{st['chains']} chains, ep_len {st['ep_len']}: {steps} policy steps, "
              f"{st['env_steps']} env steps in {st['wall_s']:.4f} s wall, {st['env_steps_per_s']:.2f} env-steps/s; "
              f"policy step {st['policy_s']:.4f} s ({100 * st['policy_share']:.2f}%, "
              f"{1e3 * st['policy_s'] / steps:.4f} ms a step), env + oracle + loop {st['env_oracle_loop_s']:.4f} s "
              f"({1e3 * st['env_oracle_loop_s'] / steps:.4f} ms a step), host clock ({card})")
    protocol_s = PROTOCOL_CHAINS * PROTOCOL_EP_LEN / batched["env_steps_per_s"]
    batched["projected_protocol_s"] = protocol_s
    print(f"[evaluator] projected: {PROTOCOL_CHAINS} chains that each time out on their first instruction at "
          f"ep_len {PROTOCOL_EP_LEN} ({PROTOCOL_CHAINS * PROTOCOL_EP_LEN} env steps) at {LANES} lanes take "
          f"{protocol_s:.1f} s at this rate ({card})")
    for st in (batched, seq):
        st["results"] = {k: st["results"][k] for k in ("avg_seq_len", "chain_sr")}
    return {"batched": batched, "sequential": seq, "profiled": idle}, batched_launches, seq_launches


# --------------------------------------------------------------------------
# training: kernels against their plain versions, at the step's shapes
# --------------------------------------------------------------------------


class TrainInputs:
    """What each training kernel is given on the main path, at its shapes:
    the synthetic batch's frames and shifts, the static camera's conv map,
    decoder-shaped mixture parameters and actions (some at the edge bins,
    some log scales below the clamp), plan logits and their noise (the
    uniforms of one ``torch.rand`` draw and their Gumbel transform),
    and the model's parameters with random gradients."""

    def __init__(self, cfg, model, batch, seed):
        from hulc_tpu_torch.ops.image_ops import draw_shifts, preprocess_rgb_seq_plain
        from hulc_tpu_torch.ops.plan_distributions import gumbel_of_uniform

        dev = model.device
        gen = torch.Generator(device=dev).manual_seed(seed + 7)
        pe, ad, d = cfg.perceptual_encoder, cfg.action_decoder, cfg.distribution
        fused = batch["fused"]
        n, s = fused.actions.shape[:2]
        self.frames = {"rgb_static": fused.rgb_static, "rgb_gripper": fused.rgb_gripper}
        self.pads = {"rgb_static": pe.rgb_static.shift_pad, "rgb_gripper": pe.rgb_gripper.shift_pad}
        self.shifts = {cam: draw_shifts(n * s, pad, gen, dev) for cam, pad in self.pads.items()}
        with torch.no_grad():
            frames = preprocess_rgb_seq_plain(fused.rgb_static).flatten(0, 1)
            self.conv_map = model.perceptual_encoder.rgb_static_encoder.conv_model(frames).contiguous()
            del frames
        self.ss_grad = torch.randn(self.conv_map.shape[0], 2 * self.conv_map.shape[1], generator=gen, device=dev)
        self.mixture, self.actions = mixture_inputs((n, s), ad.out_features - 1, ad.n_mixtures, True, gen)
        self.nll_weight = torch.randn((n, s), generator=gen, device=dev)
        self.mixture_args = (ad.act_min_bound[:-1], ad.act_max_bound[:-1], ad.num_classes,
                             ad.log_scale_min, ad.gripper_alpha)
        self.post = 2.0 * torch.randn((n, d.plan_dim), generator=gen, device=dev)
        self.prior = 2.0 * torch.randn((n, d.plan_dim), generator=gen, device=dev)
        self.uniform = torch.rand((n, d.category_size, d.class_size), generator=gen, device=dev)
        self.gumbel = gumbel_of_uniform(self.uniform)
        self.st_weight = torch.randn((n, d.plan_dim), generator=gen, device=dev)
        self.kl_weight = torch.randn((n,), generator=gen, device=dev)
        self.alpha = cfg.loss.kl_balancing_mix
        self.dist = model.dist
        self.params = [p.detach() for p in model.parameters()]
        self.adam_grads = [1e-3 * torch.randn(p.shape, generator=gen, device=dev) for p in self.params]


def mixture_inputs(lead, a, k, gripper, gen):
    """Decoder-shaped mixture parameters ([logits, log scales, means,
    gripper logits or None]) and actions (the A dims, then the gripper's in
    {-1, 1} when there is one) that reach every branch: the lowest and the
    highest bin (actions at -1 and 1), interior bins, the density fallback
    (every seventh frame has one dimension whose components all sit far
    from its action at a small scale) and the clamp (log scales below
    log_scale_min = -7, drawn from 2 * N(0, 1) - 3)."""
    dev = gen.device
    shape = (*lead, a, k)
    mixture = [
        torch.randn(shape, generator=gen, device=dev),
        2.0 * torch.randn(shape, generator=gen, device=dev) - 3.0,
        0.5 * torch.randn(shape, generator=gen, device=dev),
        torch.randn((*lead, 2), generator=gen, device=dev) if gripper else None,
    ]
    actions = torch.tanh(torch.randn((*lead, a + 1), generator=gen, device=dev))
    frames, means, log_scales = actions.view(-1, a + 1), mixture[2].view(-1, a, k), mixture[1].view(-1, a, k)
    frames[0, 0], frames[1 % len(frames), a - 1] = -1.0, 1.0
    far = min(2, a - 1)
    frames[2::7, far], means[2::7, far], log_scales[2::7, far] = 0.3, 3.0, -3.0
    actions[..., a] = torch.where(actions[..., a] > 0, 1.0, -1.0)
    return mixture, (actions if gripper else actions[..., :a].contiguous())


def branch_counts(mixture, actions, bounds, num_classes, log_scale_min):
    """How many components of these inputs take each branch of the bin's
    log mass, and how many log scales the clamp changes."""
    _, log_scales, means, _ = mixture
    a = means.shape[-2]
    x = actions[..., :a, None]
    lo, hi = (torch.tensor(b, dtype=torch.float32, device=means.device)[:, None] for b in bounds)
    half = ((hi - lo) / 2.0) / (num_classes - 1)
    inv_stdv = torch.exp(-torch.clamp_min(log_scales, log_scale_min))
    centered = x - means
    cdf_delta = torch.sigmoid(inv_stdv * (centered + half)) - torch.sigmoid(inv_stdv * (centered - half))
    lower = (x < lo + 1e-3).expand_as(means)
    upper = (x > hi - 1e-3).expand_as(means) & ~lower
    inner = ~(lower | upper)
    return {"lowest bin": int(lower.sum()), "highest bin": int(upper.sum()),
            "interior": int((inner & (cdf_delta > 1e-5)).sum()),
            "density fallback": int((inner & (cdf_delta <= 1e-5)).sum()),
            "clamp active": int((log_scales < log_scale_min).sum())}


def mixture_graph(mixture, actions, consts, use_kernel):
    """(per-frame loss, its inputs as leaves) through the kernel or the plain version."""
    from hulc_tpu_torch.ops.logistic_mixture import mixture_nll, mixture_nll_plain

    leaves = [t.clone().requires_grad_() for t in mixture if t is not None]
    fn = mixture_nll if use_kernel else mixture_nll_plain
    out = fn(*leaves[:3], actions, leaves[3] if len(leaves) == 4 else None, *consts)
    return out, leaves


def check_mixture(mixture, actions, consts, upstream, where):
    """B.3': the forward kernel against the plain version per entry
    (LOSS_RTOL), each gradient of the backward kernel within GRAD_REL
    (relative L2) of autograd through the plain forward; every branch must
    occur in the inputs. The forward keeps its gradients for the backward,
    and under no_grad it keeps and allocates none. Returns the largest
    absolute errors of the forward and of the gradients."""
    from hulc_tpu_torch.ops.logistic_mixture import mixture_nll

    counts = branch_counts(mixture, actions, consts[:2], *consts[2:4])
    if not all(counts.values()):
        fail(f"mixture NLL inputs at {where} miss a branch: {counts}")
    (k_out, k_leaves), (p_out, p_leaves) = (mixture_graph(mixture, actions, consts, use) for use in (True, False))
    shape = tuple(mixture[0].shape)
    if not torch.allclose(k_out, p_out, rtol=LOSS_RTOL, atol=0):
        fail(f"mixture NLL kernel at {where} {shape}: max abs err {max_abs(k_out, p_out)}")
    saved = [t for t in k_out.grad_fn.saved_tensors if t is not None]
    if [t.shape for t in saved] != [t.shape for t in k_leaves]:
        fail(f"mixture NLL forward at {where} kept {[tuple(t.shape) for t in saved]} for the backward")
    got = torch.autograd.grad(k_out, k_leaves, upstream)
    want = torch.autograd.grad(p_out, p_leaves, upstream)
    bwd_err = check_grads(f"mixture NLL backward kernel at {where} {shape}", got, want)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = mixture_nll(*k_leaves[:3], actions, k_leaves[3] if len(k_leaves) == 4 else None, *consts)
    extra = torch.cuda.max_memory_allocated() - base
    if out.grad_fn is not None or extra > -(-4 * out.numel() // 512) * 512:
        fail(f"mixture NLL forward under no_grad at {where}: grad_fn {out.grad_fn}, {extra} B allocated")
    if not torch.allclose(out, k_out.detach(), rtol=LOSS_RTOL, atol=0):
        fail(f"mixture NLL forward at {where} gives another loss under no_grad: {max_abs(out, k_out)}")
    print(f"[kernels] mixture NLL at {where} {shape} ({'with' if len(k_leaves) == 4 else 'no'} gripper; "
          f"branches {counts}): forward max abs err {max_abs(k_out, p_out):.3g}, gradients max abs err "
          f"{bwd_err:.3g}; no gradient kept or allocated under no_grad")
    return max_abs(k_out, p_out), bwd_err


def check_mixture_shapes(seed):
    """B.3' at hulc_debug's shape and at odd ones: 37 frames (not a
    multiple of 8 or of a tile), A = 5, K = 7 and K = 33 (a segment longer
    than a warp), with and without a gripper. Returns the largest errors."""
    from hulc_tpu_torch.config import get_config

    ad = get_config("hulc_debug").action_decoder
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    cases = [((8, 8), ad.out_features - 1, ad.n_mixtures, True, "hulc_debug")]
    cases += [((37, 1), 5, k, grip, "an odd shape") for k in (7, 33) for grip in (True, False)]
    errs = []
    for lead, a, k, grip, where in cases:
        mixture, actions = mixture_inputs(lead, a, k, grip, gen)
        consts = ((-1.0,) * a, (1.0,) * a, ad.num_classes, ad.log_scale_min, 0.7)
        errs.append(check_mixture(mixture, actions, consts, torch.randn(lead, generator=gen, device="cuda"), where))
    return max(e[0] for e in errs), max(e[1] for e in errs)


def plan_graph(inp, use_kernel, noise="uniform"):
    """((sample, KL), [posterior, prior] leaves) of ``inp``'s logits through
    the kernel or the plain version, with ``inp.uniform`` or ``inp.gumbel``
    as the noise; the leaves share the logits' memory (a misaligned view
    reaches the kernels as it is)."""
    from hulc_tpu_torch.ops.plan_distributions import DiscretePlanState

    post, prior = inp.post.detach().requires_grad_(), inp.prior.detach().requires_grad_()
    st, kl = inp.dist.rsample_balanced_kl(
        DiscretePlanState(post), DiscretePlanState(prior), inp.alpha, use_kernels=use_kernel,
        **{noise: getattr(inp, noise)},
    )
    return (st, kl), [post, prior]


def plan_case(batch, cats, classes, gen, offset=0):
    """B.4's inputs at (batch, cats, classes): logits 2 N(0, 1) (with
    ``offset``, a view that many floats into its buffer), one ``torch.rand``
    draw and its Gumbel noise, cotangents for the sample and the KL."""
    from types import SimpleNamespace

    from hulc_tpu_torch.ops.plan_distributions import PlanDistribution, gumbel_of_uniform

    dev, dim = gen.device, cats * classes

    def logits():
        return (2.0 * torch.randn(batch * dim + offset, generator=gen, device=dev))[offset:].view(batch, dim)

    uniform = torch.rand((batch, cats, classes), generator=gen, device=dev)
    return SimpleNamespace(
        dist=PlanDistribution(category_size=cats, class_size=classes), post=logits(), prior=logits(),
        uniform=uniform, gumbel=gumbel_of_uniform(uniform), alpha=0.8,
        st_weight=torch.randn((batch, dim), generator=gen, device=dev),
        kl_weight=torch.randn((batch,), generator=gen, device=dev),
    )


def check_plan(inp, where):
    """B.4 on ``inp`` from both noise entries, the uniforms (the Gumbel
    transform in the kernel) and their Gumbel noise: identical picks, the
    straight-through value within 1's ulp and the KL per entry (LOSS_RTOL)
    against the plain version, the gradients within GRAD_REL; the two
    entries give the kernel the same picks, so the same sample and KL bit
    for bit. Returns the largest forward and gradient errors."""
    grid = inp.uniform.shape
    fwd_err = bwd_err = 0.0
    outs = {}
    for noise in ("uniform", "gumbel"):
        (k_st, k_kl), k_leaves = plan_graph(inp, True, noise)
        (p_st, p_kl), p_leaves = plan_graph(inp, False, noise)
        if not torch.equal(k_st.reshape(grid).argmax(-1), p_st.reshape(grid).argmax(-1)):
            fail(f"plan kernel at {where} {tuple(grid)}, {noise} noise: other picks than the plain version")
        if not (torch.allclose(k_st, p_st, rtol=0, atol=ONE_ULP)
                and torch.allclose(k_kl, p_kl, rtol=LOSS_RTOL, atol=0)):
            fail(f"plan kernel at {where} {tuple(grid)}, {noise} noise: sample err {max_abs(k_st, p_st)}, "
                 f"KL err {max_abs(k_kl, p_kl)}")
        fwd_err = max(fwd_err, max_abs(k_st, p_st), max_abs(k_kl, p_kl))
        got = torch.autograd.grad((k_st * inp.st_weight).sum() + (k_kl * inp.kl_weight).sum(), k_leaves)
        want = torch.autograd.grad((p_st * inp.st_weight).sum() + (p_kl * inp.kl_weight).sum(), p_leaves)
        bwd_err = max(bwd_err, check_grads(f"plan backward kernel at {where} {tuple(grid)}", got, want))
        outs[noise] = (k_st.detach(), k_kl.detach())
    if not all(torch.equal(a, b) for a, b in zip(outs["uniform"], outs["gumbel"])):
        fail(f"plan kernel at {where} {tuple(grid)}: uniform and Gumbel noise give other samples")
    return fwd_err, bwd_err


def check_plan_generator(inp, seed):
    """One generator seed through the kernel path (one torch.rand draw, the
    transform in the kernel) and the plain path (gumbel_noise): identical
    picks."""
    from hulc_tpu_torch.ops.plan_distributions import DiscretePlanState

    dev = inp.uniform.device
    picks = []
    for use_kernels in (True, False):
        st, _ = inp.dist.rsample_balanced_kl(
            DiscretePlanState(inp.post), DiscretePlanState(inp.prior), inp.alpha, use_kernels=use_kernels,
            generator=torch.Generator(device=dev).manual_seed(seed),
        )
        picks.append(st.reshape(inp.uniform.shape).argmax(-1))
    if not torch.equal(*picks):
        fail("plan sample: the kernel path and the plain path pick other classes from one generator seed")


def check_gumbel_bits(gen, pairs=32768, classes=32):
    """The kernel's Gumbel transform bit for bit against the plain
    ``gumbel_of_uniform`` (``gumbel_noise``'s), read off the picks: each row
    of ``classes`` uniforms has logits -g - 64 (g the plain transform) but
    at two adjacent classes (a, a + 1), where they are -g, so the kernel's
    g + logit is exactly 0 there when its g is the plain one's, and the pick
    is a (the first index). Each pair of values also sits in the next row
    swapped: if the kernel's g differs from the plain g at either value, one
    of the two rows picks a + 1 (unless both differ by the same amount)."""
    from hulc_tpu_torch.ops.plan_distributions import DiscretePlanState, PlanDistribution, gumbel_of_uniform

    dev = gen.device
    rows = 2 * pairs
    uniform = torch.rand((pairs, classes), generator=gen, device=dev).repeat_interleave(2, 0)
    values = torch.rand((pairs, 2), generator=gen, device=dev)
    a = (torch.arange(rows, device=dev) // 2) % (classes // 2) * 2
    cols = torch.stack([a, a + 1], -1)
    uniform.scatter_(1, cols, torch.stack([values, values.flip(-1)], 1).reshape(rows, 2))
    g = gumbel_of_uniform(uniform)
    post = (-g - 64.0).scatter_(1, cols, -g.gather(1, cols))
    cats = 32
    dist = PlanDistribution(category_size=cats, class_size=classes)
    st, _ = dist.rsample_balanced_kl(DiscretePlanState(post.reshape(rows // cats, -1)),
                                     DiscretePlanState(torch.zeros_like(post).reshape(rows // cats, -1)), 0.8,
                                     uniform=uniform.reshape(rows // cats, cats, classes))
    picks = st.reshape(rows, classes).argmax(-1)
    if not torch.equal(picks, a):
        bad = int((picks != a).sum())
        fail(f"plan kernel's Gumbel transform differs from gumbel_noise's: {bad} of {rows} rows picked otherwise")
    return 2 * pairs


def check_plan_nan(gen):
    """B.4's pick with NaN in the Gumbel noise (two NaN classes in every
    other row, one in every fourth) at (8, 32, 32): argmax's first NaN, as
    the plain version picks it, in each of three launches."""
    case = plan_case(8, 32, 32, gen)
    rows = case.gumbel.view(-1, 32)
    rows[::2, 16] = rows[::2, 31] = rows[1::4, 1] = float("nan")
    with torch.no_grad():
        want = plan_graph(case, False, "gumbel")[0][0].reshape(case.gumbel.shape).argmax(-1)
        for _ in range(3):  # the pick must not depend on which lane runs first
            got = plan_graph(case, True, "gumbel")[0][0].reshape(case.gumbel.shape).argmax(-1)
            if not torch.equal(got, want):
                fail(f"plan kernel picks other classes than torch.argmax with NaN noise: {int((got != want).sum())}")


def check_plan_shapes(seed):
    """B.4 at hulc_debug's (6, 4, 4), odd (3, 5, 7), rows wider than one
    32-class chunk (3, 2, 64) and (2, 3, 70), more categories than rows in
    flight (2, 40, 8), and the step's (64, 32, 32) as a view 4 bytes off
    16-byte alignment (scalar accesses); then NaN noise (``check_plan_nan``).
    Returns the largest errors."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    cases = [((6, 4, 4), 0, "hulc_debug"), ((3, 5, 7), 0, "an odd shape"), ((3, 2, 64), 0, "two chunks"),
             ((2, 3, 70), 0, "an odd shape in three chunks"), ((2, 40, 8), 0, "40 categories"),
             ((64, 32, 32), 1, "a misaligned view")]
    errs = []
    for shape, offset, where in cases:
        case = plan_case(*shape, gen, offset)
        if offset and case.post.data_ptr() % 16 == 0:
            fail("the misaligned plan logits start 16-byte aligned")
        errs.append(check_plan(case, where))
    check_plan_nan(gen)
    print(f"[kernels] plan sample and KL at {[c[0] for c in cases]} (the last a misaligned view), uniform and "
          f"Gumbel noise: identical picks, forward max abs err {max(e[0] for e in errs):.3g}, gradients "
          f"{max(e[1] for e in errs):.3g}; with NaN noise, torch.argmax's picks")
    return max(e[0] for e in errs), max(e[1] for e in errs)


def check_grads(name, got, want):
    errs = [rel_l2(g, w) for g, w in zip(got, want)]
    if not max(errs) <= GRAD_REL:
        fail(f"{name}: gradients differ from autograd through the plain version, relative L2 {errs}")
    return max(max_abs(g, w) for g, w in zip(got, want))


def check_ss_bwd(conv_map, grad, where):
    """The SpatialSoftmax backward on ``conv_map``: dx against autograd
    through the plain forward at a fixed T = 1 (the wrapper) and at a
    learnable T = 0.7 (through the autograd Function, the temperature a
    CUDA tensor), and dT against autograd's within SS_DTEMP_RTOL. Returns
    (largest dx error, dT relative error)."""
    from hulc_tpu_torch.models.vision import spatial_softmax, spatial_softmax_bwd, spatial_softmax_plain

    x = conv_map.clone().requires_grad_()
    (want,) = torch.autograd.grad(spatial_softmax_plain(x, 1.0), x, grad)
    got, _ = spatial_softmax_bwd(conv_map, grad, 1.0)
    if not torch.allclose(got, want, rtol=SS_BWD_RTOL, atol=SS_BWD_ATOL):
        fail(f"SpatialSoftmax backward kernel at {where} {tuple(x.shape)}: max abs err {max_abs(got, want)}")
    dx_err = max_abs(got, want)
    del got, want
    temp = torch.tensor([0.7], device=conv_map.device, requires_grad=True)
    want, want_t = torch.autograd.grad(spatial_softmax_plain(x, temp), (x, temp), grad)
    # a leaf on conv_map's own memory: a misaligned view reaches the kernels as it is
    x_k, temp_k = conv_map.detach().requires_grad_(), temp.detach().clone().requires_grad_()
    got, got_t = torch.autograd.grad(spatial_softmax(x_k, temp_k), (x_k, temp_k), grad)
    if not torch.allclose(got, want, rtol=SS_BWD_RTOL, atol=SS_BWD_ATOL):
        fail(f"SpatialSoftmax backward kernel, learnable T, at {where} {tuple(x.shape)}: "
             f"max abs err {max_abs(got, want)}")
    dt_err = float((got_t - want_t).abs() / want_t.abs())
    if not (got_t.shape == temp.shape and dt_err <= SS_DTEMP_RTOL):
        fail(f"SpatialSoftmax temperature gradient at {where}: {float(got_t)} vs {float(want_t)} (relative {dt_err})")
    return max(dx_err, max_abs(got, want)), dt_err


def check_shift(imgs, shifts, pad, where):
    from hulc_tpu_torch.ops.image_ops import preprocess_rgb_seq_shift, preprocess_rgb_seq_shift_plain

    got = preprocess_rgb_seq_shift(imgs, shifts, pad)
    want = preprocess_rgb_seq_shift_plain(imgs, shifts, pad)
    if not torch.equal(got, want):
        fail(f"shift kernel at {where} {tuple(imgs.shape)} is not bit-equal: max abs err {max_abs(got, want)}")


def check_train_kernels(inp):
    """Each training kernel against its plain version on ``inp``; returns
    the largest absolute error of each."""
    errs = {}
    # B.1': a gather on uint8 and the plain version's normalize table, so bit-equal
    for cam, imgs in inp.frames.items():
        check_shift(imgs, inp.shifts[cam], inp.pads[cam], "the step's shape")
    errs["preprocess_rgb_shift"] = 0.0

    # B.2 at the step's shape, fixed and learnable T
    errs["spatial_softmax_train"] = check_ss_fwd(inp.conv_map, "the step's shape")

    # B.2' and B.2'': against autograd through the plain forward
    errs["spatial_softmax_bwd"], errs["spatial_softmax_bwd_dtemp_rel"] = check_ss_bwd(
        inp.conv_map, inp.ss_grad, "the step's shape"
    )

    # B.3': forward per entry, each gradient as a tensor, every branch present
    errs["mixture_nll_fwd"], errs["mixture_nll_bwd"] = check_mixture(
        inp.mixture, inp.actions, inp.mixture_args, inp.nll_weight, "the step's shape"
    )

    # B.4: both noise entries, identical picks, the straight-through value
    # within 1's ulp, KL per entry; one generator seed on both paths; the
    # in-kernel Gumbel transform bit for bit
    errs["plan_st_kl_fwd"], errs["plan_st_kl_bwd"] = check_plan(inp, "the step's shape")
    check_plan_generator(inp, 23)
    n_bits = check_gumbel_bits(torch.Generator(device=inp.uniform.device).manual_seed(29))
    print(f"[kernels] plan sample at the step's shape: uniform and Gumbel entries agree with the plain version "
          f"and with each other, one generator seed picks the same classes on both paths, the in-kernel Gumbel "
          f"transform is gumbel_noise's bit for bit on {n_bits} uniforms")

    # B.5 and B.7: two steps on copies of the model's params, bit-equal (the
    # second reads nonzero bf16 moments); the norm of the same gradients
    check_adam_steps([p.numel() for p in inp.params], inp.params, inp.adam_grads, lambda *arrays: arrays)
    errs["adam_lowp"] = 0.0
    errs["grad_norm"] = check_grad_norm(lambda: adam_state(inp.params), inp.adam_grads, "the model's gradients")
    check_adam_shapes(inp.params[0].device)
    return errs


def adam_state(params):
    """Copies of ``params`` and zero bf16 moments, as AdamLowp starts."""
    ps = [p.clone() for p in params]
    return ps, [torch.zeros_like(p, dtype=torch.bfloat16) for p in ps], [torch.zeros_like(p, dtype=torch.bfloat16) for p in ps]


def check_grad_norm(make_state, grads, where):
    """The two launches on fresh state (``make_state()``: params and zero
    moments, as laid out for the kernel): the block partials against the
    plain fp64 sums of each block's range (PARTIALS_RTOL), bit-equal on a
    second launch; the finish bit-equal to its plain mirror of the same
    order; the norm within GRAD_NORM_RTOL of an fp64 sum of the gradients
    and of the plain ``global_norm``. Returns its absolute error against
    the fp64 sum."""
    from hulc_tpu_torch.training.optimizers import (
        adam_lowp_launch, global_norm, grad_norm_finish, grad_norm_finish_plain, grad_norm_partials_plain,
    )

    c1, c2 = bias_corrections(1)
    runs = []
    for _ in range(2):
        ps, ms, vs = make_state()
        partials = adam_lowp_launch(ps, grads, ms, vs, 0.9, 0.999, 1e-8, -2e-4, c1, c2)
        runs.append((partials, grad_norm_finish(partials)))
    (partials, norm), (partials2, norm2) = runs
    if not (torch.equal(partials, partials2) and torch.equal(norm, norm2)):
        fail(f"grad norm at {where}: two launches on the same inputs differ")
    want_partials = grad_norm_partials_plain(ps, grads)
    if not torch.allclose(partials.cpu(), want_partials, rtol=PARTIALS_RTOL, atol=0):
        fail(f"grad norm at {where}: block partials differ from the plain sums of their ranges by up to "
             f"{max_abs(partials.cpu(), want_partials)}")
    if not torch.equal(norm.cpu(), grad_norm_finish_plain(partials)):
        fail(f"grad norm finish at {where}: {float(norm)!r}, its plain mirror {float(grad_norm_finish_plain(partials))!r}")
    want = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads if g is not None)))
    if not abs(float(norm) - want) <= GRAD_NORM_RTOL * want:
        fail(f"grad norm at {where}: {float(norm)!r}, fp64 sum {want!r}")
    if not torch.allclose(norm, global_norm(grads), rtol=GRAD_NORM_RTOL, atol=0):
        fail(f"grad norm at {where}: {float(norm)!r}, plain global_norm {float(global_norm(grads))!r}")
    return abs(float(norm) - want)


def check_adam_shapes(device):
    """B.5 and B.7 on the paths the step's tensors do not take: numel 1, 3,
    4, 5, 16,383, 16,385 and 4,194,304 (a head, a scalar tail, one and
    several blocks), a parameter without a gradient, zero gradients beside
    nonzero ones, and all four arrays one element into their storage (a
    head of 3); then 500 small tensors, more than one launch takes (two
    launches). Two steps bit-equal to the plain version; the norm as
    ``check_grad_norm``. A p that is a view 4 bytes past a 16-byte boundary
    beside fresh g, m, v (its arrays at different phases) is refused."""
    from hulc_tpu_torch.training.optimizers import MAX_GRADS_PER_LAUNCH, adam_lowp_update, vector_head

    gen = torch.Generator(device=device).manual_seed(17)
    # 4,096 without a gradient, every other gradient of 16,383 zero, 1,001 as views
    sizes = (1, 3, 4, 5, 16383, 16385, 4194304, 4096, 1001)
    params = [torch.randn(n, generator=gen, device=device) for n in sizes]
    grads = [1e-3 * torch.randn(n, generator=gen, device=device) for n in sizes]
    grads[7] = None
    grads[4][::2] = 0.0  # zero gradients beside nonzero ones in one warp

    def shifted(t):
        return torch.cat([t.new_zeros(1), t])[1:]

    def lay_out(ps, ms, vs, gs):
        """All four arrays of the last tensor moved one element into new storages."""
        ps, ms, vs, gs = list(ps), list(ms), list(vs), list(gs)
        for arrays in (ps, ms, vs, gs):
            arrays[-1] = shifted(arrays[-1])
        return ps, ms, vs, gs

    ps, ms, vs, gs = lay_out(*adam_state(params), grads)
    heads = {vector_head(p.data_ptr(), p.numel()) for p in ps}
    if not {0, 3} <= heads:
        fail(f"adam kernel check: the layouts did not reach a head of 0 and of 3, heads {sorted(heads)}")
    check_adam_steps(sizes, params, grads, lay_out)
    check_grad_norm(lambda: lay_out(*adam_state(params), grads)[:3], gs, f"sizes {sizes} with a view")

    many = torch.randint(1, 40, (500,), generator=gen, device=device).tolist()
    if not len(many) > MAX_GRADS_PER_LAUNCH:
        fail("the many-tensor case fits one launch")
    many_params = [torch.randn(n, generator=gen, device=device) for n in many]
    many_grads = [1e-3 * torch.randn(n, generator=gen, device=device) for n in many]
    check_adam_steps(many, many_params, many_grads, lambda *arrays: arrays)
    check_grad_norm(lambda: adam_state(many_params), many_grads, "500 small tensors")

    ps, ms, vs = adam_state(params[-1:])
    try:
        adam_lowp_update([shifted(ps[0])], grads[-1:], ms, vs, 0.9, 0.999, 1e-8, -2e-4, *bias_corrections(1))
    except ValueError as e:
        refusal = str(e)
    else:
        fail("adam kernel: a p view at another phase than its g, m, v was not refused")
    print(f"[kernels] adam and grad norm at sizes {sizes} (4096 without a gradient, 1001 a view of all four "
          f"arrays) and at 500 small tensors (two launches): bit-equal, norm within {GRAD_NORM_RTOL} of fp64; "
          f"a p view 4 bytes off its moments' phase refused ({refusal})")


def check_adam_steps(sizes, params, grads, lay_out):
    """Two steps from zero moments through the kernel (on the tensors as
    ``lay_out`` places them) and through the plain version: params and
    moments bit-equal."""
    from hulc_tpu_torch.training.optimizers import adam_lowp_update, adam_update_plain

    sides = []
    for kernel in (True, False):
        ps, ms, vs = adam_state(params)
        gs = list(grads)
        if kernel:
            ps, ms, vs, gs = lay_out(ps, ms, vs, gs)
        for count, lr in ((1, 2e-4), (2, 1e-4)):
            c1, c2 = bias_corrections(count)
            if kernel:
                adam_lowp_update(ps, gs, ms, vs, 0.9, 0.999, 1e-8, -lr, c1, c2)
            else:
                for p, g, m, v in zip(ps, gs, ms, vs):
                    adam_update_plain(p, g, m, v, 0.9, 0.999, 1e-8, -lr, c1, c2)
        sides.append((ps, ms, vs))
    for what, got, want in zip(("params", "exp_avg", "exp_avg_sq"), sides[0], sides[1]):
        for n, g, w in zip(sizes, got, want):
            if not torch.equal(g, w):
                fail(f"adam kernel: {what} of a {n}-element tensor not bit-equal to the plain version")


def bias_corrections(count):
    from hulc_tpu_torch.training.optimizers import bias_corrections as bc

    return bc(0.9, 0.999, count)


def with_learnable_temperature(cfg):
    pe = cfg.perceptual_encoder
    learnable = dataclasses.replace(pe.rgb_static, spatial_softmax_temp=None)
    return dataclasses.replace(cfg, perceptual_encoder=dataclasses.replace(pe, rgb_static=learnable)).resolve()


def check_debug(seed):
    """``hulc_debug`` (its 64 px and 48 px frames, 4x4 maps): the shift
    kernel, the SpatialSoftmax forward and backward at its shapes, and
    those and the eval preprocess again at odd shapes (a frame view one byte
    off alignment with w = 37, a (5, 3, 7, 7) map: unaligned heads, scalar
    stores, a partial block; and its view ``[1:]``, which starts 12 bytes
    off 16-byte alignment, fixed and learnable T). Returns the largest
    forward error, dx error and dT relative error."""
    from hulc_tpu_torch.config import get_config
    from hulc_tpu_torch.models import make_model
    from hulc_tpu_torch.ops.image_ops import draw_shifts, preprocess_rgb_seq_plain
    from hulc_tpu_torch.training.profile_train import synthetic_fused_batch

    cfg = get_config("hulc_debug")
    pe = cfg.perceptual_encoder
    model = make_model(cfg, "cuda", seed=seed)
    batch = synthetic_fused_batch(cfg, 4, 8, seed, "cuda")
    fused = batch["fused"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    for cam in ("rgb_static", "rgb_gripper"):
        imgs, pad = getattr(fused, cam), getattr(pe, cam).shift_pad
        check_shift(imgs, draw_shifts(imgs.shape[0] * imgs.shape[1], pad, gen, "cuda"), pad, "hulc_debug")
    raw = torch.randint(0, 256, (6 * 37 * 37 * 3 + 1,), generator=gen, device="cuda", dtype=torch.uint8)
    odd_frames = raw[1:].view(3, 2, 37, 37, 3)
    check_shift(odd_frames, draw_shifts(6, 5, gen, "cuda"), 5, "an odd shape")
    check_preprocess(odd_frames, "an odd shape")
    for cam in ("rgb_static", "rgb_gripper"):
        check_preprocess(getattr(fused, cam), "hulc_debug")
    with torch.no_grad():
        frames = preprocess_rgb_seq_plain(fused.rgb_static).flatten(0, 1)
        conv_map = model.perceptual_encoder.rgb_static_encoder.conv_model(frames).contiguous()
    odd = torch.randn((5, 3, 7, 7), generator=gen, device="cuda")
    misaligned = odd[1:]  # starts 588 bytes in, 12 mod 16: the wrappers copy it to an aligned buffer
    if misaligned.data_ptr() % 16 == 0:
        fail("the misaligned SpatialSoftmax map starts 16-byte aligned")
    fwd_err = max(check_ss_fwd(conv_map, "hulc_debug"), check_ss_fwd(odd, "an odd shape"),
                  check_ss_fwd(misaligned, "a misaligned view"))
    errs = [check_ss_bwd(conv_map, torch.randn(conv_map.shape[0], 2 * conv_map.shape[1], generator=gen,
                                               device="cuda"), "hulc_debug")]
    errs.append(check_ss_bwd(odd, torch.randn((5, 6), generator=gen, device="cuda"), "an odd shape"))
    errs.append(check_ss_bwd(misaligned, torch.randn((4, 6), generator=gen, device="cuda"), "a misaligned view"))
    print(f"[kernels] shift and eval preprocess bit-equal, SpatialSoftmax forward and backward (fixed and "
          f"learnable T) within tolerance at hulc_debug's shapes ({tuple(fused.rgb_static.shape)}, "
          f"{tuple(fused.rgb_gripper.shape)}, {tuple(conv_map.shape)}) and odd ones: forward max abs err "
          f"{fwd_err:.3g}, dx max abs err {max(e[0] for e in errs):.3g}, dT relative err "
          f"{max(e[1] for e in errs):.3g}")
    del model
    return fwd_err, max(e[0] for e in errs), max(e[1] for e in errs)


def recurrence_case(b, s, h, gen, w=None, bias=None, xp=None, carry=True):
    """One layer's inputs for B.6 and cotangents: W and b_hh at torch's
    U(-1/sqrt(H), 1/sqrt(H)) unless given, xp ~ N(0, 1) unless given (about
    half the units active), h0 and dcarry nonzero with ``carry`` (h0 a relu
    of N(0, 1), as a carry is) or zeros and None, dy ~ N(0, 1)."""
    dev = gen.device

    def uniform(*shape):
        return (2.0 * torch.rand(shape, generator=gen, device=dev) - 1.0) / h**0.5

    w = uniform(h, h) if w is None else w.detach()
    bias = uniform(h) if bias is None else bias.detach()
    xp = torch.randn((b, s, h), generator=gen, device=dev) if xp is None else xp.detach()
    h0 = torch.relu(torch.randn((b, h), generator=gen, device=dev)) if carry else torch.zeros((b, h), device=dev)
    dcarry = torch.randn((b, h), generator=gen, device=dev) if carry else None
    return xp, h0, w, bias, torch.randn((b, s, h), generator=gen, device=dev), dcarry


def check_recurrence_case(xp, h0, w, bias, dy, dcarry, where):
    """B.6 on one layer: the forward kernel's y (and its final state)
    against the plain loop, and the autograd Function's four gradients (its
    backward kernel, then the dW product and the bias sum) against
    ``rnn_relu_bwd_plain`` on the plain y and against autograd through the
    plain loop, each within REC_REL (relative L2). Returns (plain y, largest
    absolute error of y, of the gradients)."""
    from hulc_tpu_torch.ops.recurrence import rnn_relu, rnn_relu_bwd_plain, rnn_relu_fwd, rnn_relu_fwd_plain

    shape = tuple(xp.shape)
    got, got_last = rnn_relu_fwd(xp, h0, w, bias)
    want = rnn_relu_fwd_plain(xp, h0, w, bias)
    if not (rel_l2(got, want) <= REC_REL and torch.equal(got_last, got[:, -1])):
        fail(f"recurrence forward kernel at {where} {shape}: relative L2 {rel_l2(got, want)}, "
             f"final state equal to y[:, -1]: {torch.equal(got_last, got[:, -1])}")
    outs = [dy] if dcarry is None else [dy, dcarry]
    leaves = [t.clone().requires_grad_() for t in (xp, h0, w, bias)]
    k_grads = torch.autograd.grad(rnn_relu(*leaves)[:len(outs)], leaves, outs)
    closed = rnn_relu_bwd_plain(dy, want, dcarry, h0, w)
    leaves = [t.clone().requires_grad_() for t in (xp, h0, w, bias)]
    y = rnn_relu_fwd_plain(*leaves)
    auto = torch.autograd.grad([y, y[:, -1]][:len(outs)], leaves, outs)
    names = ("dxp", "dh0", "dW_hh", "db_hh")
    errs = {f"{n} vs {ref}": rel_l2(g, r) for ref, wants in (("closed form", closed), ("autograd", auto))
            for n, g, r in zip(names, k_grads, wants)}
    if not max(errs.values()) <= REC_REL:
        fail(f"recurrence backward at {where} {shape}: relative L2 {errs}")
    bwd_err = max(max_abs(g, r) for g, r in zip(k_grads, auto))
    print(f"[kernels] recurrence at {where} {shape} ({'nonzero' if dcarry is not None else 'zero'} carry): "
          f"y relative L2 {rel_l2(got, want):.3g}, max abs err {max_abs(got, want):.3g}; gradients relative L2 "
          f"up to {max(errs.values()):.3g}, max abs err {bwd_err:.3g}")
    return want, max_abs(got, want), bwd_err


def check_recurrence(model, seed):
    """B.6 at every shape it runs at: the train step's (64, 32, 2048) through
    both decoder layers (the model's weights; zero carry, no carry gradient,
    as the step has), one, eight and 64 serving lanes at S = 1 with a
    nonzero carry (the one-step GEMV launch at one and eight, a one-step
    cluster launch at 64), 96 rows at (96, 3, 2048), ``hulc_debug``'s H =
    64, an odd (3, 5, 37) and a (3, 5, 5) that one block a cluster takes.
    Returns the largest forward and gradient errors."""
    import torch.nn.functional as F

    from hulc_tpu_torch.config import get_config
    from hulc_tpu_torch.models import make_model

    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    rnn = model.action_decoder.rnn
    h = rnn.hidden_size
    params = [{n: getattr(rnn, f"{n}_l{k}") for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
              for k in range(rnn.num_layers)]
    errs = []
    for k, p in enumerate(params):
        # layer 0's xp ~ N(0, 1); layer k > 0's is layer k - 1's plain output through W_ih
        with torch.no_grad():
            xp = None if k == 0 else F.linear(y, p["weight_ih"], p["bias_ih"])
        case = recurrence_case(DECODER_ROWS, DECODER_SEQ, h, gen, p["weight_hh"], p["bias_hh"], xp, carry=False)
        y, *e = check_recurrence_case(*case, f"the train step, layer {k}")
        errs.append(e)
    for lanes, launch in ((1, "step"), (8, "step"), (64, "sequence")):
        if recurrence_plan_for(lanes, 1, h, backward=False).launch != launch:
            fail(f"the recurrence's forward at {lanes} lanes is not a {launch} launch")
        case = recurrence_case(lanes, 1, h, gen, params[0]["weight_hh"], params[0]["bias_hh"])
        errs.append(check_recurrence_case(*case, f"{lanes} serving lane(s)")[1:])
    case = recurrence_case(96, 3, h, gen, params[0]["weight_hh"], params[0]["bias_hh"])
    errs.append(check_recurrence_case(*case, "two row tiles")[1:])
    debug = make_model(get_config("hulc_debug"), "cuda", seed=seed).action_decoder.rnn
    case = recurrence_case(8, 8, debug.hidden_size, gen, debug.weight_hh_l0, debug.bias_hh_l0)
    errs.append(check_recurrence_case(*case, "hulc_debug")[1:])
    errs.append(check_recurrence_case(*recurrence_case(3, 5, 37, gen), "an odd shape")[1:])
    errs.append(check_recurrence_case(*recurrence_case(3, 5, 5, gen), "a hidden size too small to split")[1:])
    return max(e[0] for e in errs), max(e[1] for e in errs)


def recurrence_plan_for(b, s, h, backward):
    """The launch plan ``ops.recurrence`` makes for one layer on this card."""
    from hulc_tpu_torch.ops.recurrence import device_plan

    return device_plan(h, b, s, torch.cuda.current_device(), backward)


def time_recurrence(model, seed):
    """Device ms of the B.6 kernels at the train step's (64, 32, 2048) (the
    forward also at one and 64 serving lanes), of their plain versions on
    the same inputs, and of cuDNN's relu RNN as the library yardstick: one
    ``torch.nn.RNN`` layer with W_ih = I and b_ih = 0, so it computes the
    same function of xp (plus one product by I), forward, and the backward of
    its graph; the port never calls it. Also the whole recurrence backward
    (kernel, dW product, bias sum) against autograd through the loop. All
    by CUDA events (``kernel_times.event_ms``: each window queued behind a
    spin of the device, so the host's launch cost does not enter), in turns
    plain, kernel, kernel, plain."""
    from hulc_tpu_torch.evaluation.kernel_times import event_ms
    from hulc_tpu_torch.ops.recurrence import (
        dh_chain_plain, rnn_relu, rnn_relu_bwd, rnn_relu_fwd, rnn_relu_fwd_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 29)
    rnn = model.action_decoder.rnn
    h = rnn.hidden_size
    w, bias = rnn.weight_hh_l0.detach(), rnn.bias_hh_l0.detach()
    cudnn = torch.nn.RNN(h, h, nonlinearity="relu", batch_first=True, device="cuda")
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(torch.eye(h, device="cuda"))
        cudnn.bias_ih_l0.zero_()
        cudnn.weight_hh_l0.copy_(w)
        cudnn.bias_hh_l0.copy_(bias)
    out = {}

    def fwd_case(b, s):
        xp, h0, *_ = recurrence_case(b, s, h, gen, w, bias, carry=s == 1)
        with torch.no_grad():
            lib_y, _ = cudnn(xp, h0[None])
            if rel_l2(lib_y, rnn_relu_fwd_plain(xp, h0, w, bias)) > 1e-4:
                fail(f"cuDNN's relu RNN does not compute the recurrence at {(b, s, h)}")
        # W and y read or written once: (B S H) in and out, W, b_hh, h0
        return (lambda: rnn_relu_fwd(xp, h0, w, bias), lambda: rnn_relu_fwd_plain(xp, h0, w, bias),
                bound(4 * (2 * b * s * h + h * h + h + b * h), 2 * b * s * h * h), lambda: cudnn(xp, h0[None]))

    xp, h0, _, _, dy, _ = recurrence_case(DECODER_ROWS, DECODER_SEQ, h, gen, w, bias, carry=False)
    y, _ = rnn_relu_fwd(xp, h0, w, bias)
    leaves_k = [t.clone().requires_grad_() for t in (xp, h0, w, bias)]
    y_k, _ = rnn_relu(*leaves_k)
    leaves_p = [t.clone().requires_grad_() for t in (xp, h0, w, bias)]
    y_p = rnn_relu_fwd_plain(*leaves_p)
    lib_xp, lib_h0 = xp.clone().requires_grad_(), h0[None].clone().requires_grad_()
    lib_y, _ = cudnn(lib_xp, lib_h0)
    lib_leaves = [lib_xp, lib_h0, *cudnn.parameters()]
    b, s = xp.shape[:2]
    cases = {
        "rnn_relu_fwd": fwd_case(b, s),
        "rnn_relu_fwd_64_lanes": fwd_case(64, 1),
        "rnn_relu_fwd_1_lane": fwd_case(1, 1),
        # dy, y in; dpre out; W; h0 out: the dh chain's 2 B S H^2 FLOP
        "rnn_relu_bwd": (lambda: rnn_relu_bwd(dy, y, None, w), lambda: dh_chain_plain(dy, y, None, w),
                         bound(4 * (3 * b * s * h + h * h + b * h), 2 * b * s * h * h),
                         lambda: torch.autograd.grad(lib_y, lib_leaves, dy, retain_graph=True)),
        # the Function's whole backward (dh chain, dW product, bias sum) against
        # autograd through the loop: twice the FLOP, dW written too
        "rnn_relu_backward_all": (
            lambda: torch.autograd.grad(y_k, leaves_k, dy, retain_graph=True),
            lambda: torch.autograd.grad(y_p, leaves_p, dy, retain_graph=True),
            bound(4 * (4 * b * s * h + 2 * h * h + b * h), 4 * b * s * h * h),
            lambda: torch.autograd.grad(lib_y, lib_leaves, dy, retain_graph=True),
        ),
    }
    plans = {"rnn_relu_fwd": (b, s, False), "rnn_relu_fwd_64_lanes": (64, 1, False),
             "rnn_relu_fwd_1_lane": (1, 1, False), "rnn_relu_bwd": (b, s, True)}
    for name, (kernel_fn, plain_fn, (bound_ms, bound_by), library_fn) in cases.items():
        ms_ = [event_ms(plain_fn, 10), event_ms(kernel_fn), event_ms(kernel_fn), event_ms(plain_fn, 10)]
        out[name] = {
            "ms": min(ms_[1], ms_[2]), "plain_ms": min(ms_[0], ms_[3]), "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": event_ms(library_fn, 10), "call_ms": call_ms(kernel_fn, 20),
            "plain_call_ms": call_ms(plain_fn, 20), "timed_by": "CUDA events",
        }
        if name in plans:
            out[name]["plan"] = dataclasses.asdict(recurrence_plan_for(*plans[name][:2], h, plans[name][2]))
    out["rnn_relu_fwd"]["shape"] = out["rnn_relu_bwd"]["shape"] = [b, s, h]
    return out


def time_train_kernels(inp):
    """Device ms of each training kernel and of its plain version on the
    same inputs, the bound, and the library yardsticks: for the optimizer
    tail (Adam and the gradient norm) fused fp32 Adam's step plus
    ``torch.nn.utils.get_total_norm``, for the norm alone
    ``get_total_norm``."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.evaluation.kernel_times import event_ms
    from hulc_tpu_torch.models.vision import spatial_softmax, spatial_softmax_bwd, spatial_softmax_plain
    from hulc_tpu_torch.ops.image_ops import preprocess_rgb_seq_shift, preprocess_rgb_seq_shift_plain
    from hulc_tpu_torch.ops.logistic_mixture import mixture_nll, mixture_nll_plain
    from hulc_tpu_torch.training.optimizers import (
        PointerTable, adam_lowp_launch, adam_lowp_update, adam_update_plain, global_norm, grad_norm_finish,
    )

    def shift(fn):
        return lambda: [fn(imgs, inp.shifts[cam], inp.pads[cam]) for cam, imgs in inp.frames.items()]

    x = inp.conv_map.clone().requires_grad_()
    ss_out = spatial_softmax_plain(x, 1.0)
    temp = torch.tensor([0.7], device=x.device, requires_grad=True)
    ss_out_t = spatial_softmax_plain(x, temp)
    k_nll, k_nll_leaves = mixture_graph(inp.mixture, inp.actions, inp.mixture_args, True)
    p_nll, p_nll_leaves = mixture_graph(inp.mixture, inp.actions, inp.mixture_args, False)
    (k_st, k_kl), k_plan_leaves = plan_graph(inp, True)
    (p_st, p_kl), p_plan_leaves = plan_graph(inp, False)
    k_plan_loss = (k_st * inp.st_weight).sum() + (k_kl * inp.kl_weight).sum()
    grid, d_kl = inp.uniform.shape, inp.kl_weight

    def plan_bwd(st, kl, leaves):
        """The backward of the function alone: the sample's and the KL's
        cotangents to the logits' gradients."""
        return lambda: torch.autograd.grad((st, kl), leaves, (inp.st_weight, d_kl), retain_graph=True)

    def nll_fwd(fn, grad):
        """The forward as the train step runs it (inputs that require grad:
        the kernel also writes the gradients), or under no_grad."""
        def run():
            with torch.set_grad_enabled(grad):
                fn(*k_nll_leaves[:3], inp.actions, k_nll_leaves[3], *inp.mixture_args)
        return run

    def plan_fwd(use_kernel):
        def run():
            with torch.no_grad():
                plan_graph(inp, use_kernel)
        return run

    ps, ms, vs = adam_state(inp.params)
    c1, c2 = bias_corrections(1)
    table = PointerTable()  # as AdamLowp keeps it: built on the first call only

    def adam_plain():
        """The plain optimizer tail: the eager norm, then each tensor's update."""
        global_norm(inp.adam_grads)
        for p, g, m, v in zip(ps, inp.adam_grads, ms, vs):
            adam_update_plain(p, g, m, v, 0.9, 0.999, 1e-8, -2e-4, c1, c2)

    fused_params = [torch.nn.Parameter(p.clone()) for p in inp.params]
    for p, g in zip(fused_params, inp.adam_grads):
        p.grad = g
    fused_adam = torch.optim.Adam(fused_params, lr=2e-4, fused=True)

    def library_tail():
        torch.nn.utils.get_total_norm(inp.adam_grads)
        fused_adam.step()

    p0, m0, v0 = adam_state(inp.params)
    partials = adam_lowp_launch(p0, inp.adam_grads, m0, v0, 0.9, 0.999, 1e-8, -2e-4, c1, c2)
    n_blocks = partials.numel()
    del p0, m0, v0

    n_px = sum(t.numel() for t in inp.frames.values())
    n_frames = sum(t.shape[0] * t.shape[1] for t in inp.frames.values())
    n_map = inp.conv_map.numel()
    n_comp = inp.mixture[0].numel()
    rows = inp.actions.shape[0] * inp.actions.shape[1]
    small = 4 * (inp.actions.numel() + inp.mixture[3].numel() + rows)
    n_plan = inp.post.numel()
    n_params = sum(p.numel() for p in inp.params)
    cases = {
        # B.2 as the step runs it: the map read once, (N, 2C) written once; ~9 flops per logit
        "spatial_softmax_train": (lambda: spatial_softmax(inp.conv_map, 1.0),
                                  lambda: spatial_softmax_plain(inp.conv_map, 1.0),
                                  bound(4 * n_map + 4 * inp.ss_grad.numel(), 9 * n_map), None),
        # u8 in, fp32 out, the shifts; mul, sub, div per element
        "preprocess_rgb_shift": (shift(preprocess_rgb_seq_shift), shift(preprocess_rgb_seq_shift_plain),
                                 bound(5 * n_px + 8 * n_frames, 3 * n_px), None),
        # map in, dx out, grad_out in; ~12 flops per entry (exp, divides, the product)
        "spatial_softmax_bwd": (lambda: spatial_softmax_bwd(inp.conv_map, inp.ss_grad, 1.0),
                                lambda: torch.autograd.grad(ss_out, x, inp.ss_grad, retain_graph=True),
                                bound(8 * n_map + 4 * inp.ss_grad.numel(), 12 * n_map), None),
        # the same and T in, dT out; two more flops an entry (x * dx, its sum)
        "spatial_softmax_bwd_learnable_t": (
            lambda: spatial_softmax_bwd(inp.conv_map, inp.ss_grad, temp.detach()),
            lambda: torch.autograd.grad(ss_out_t, (x, temp), inp.ss_grad, retain_graph=True),
            bound(8 * n_map + 4 * inp.ss_grad.numel() + 8, 14 * n_map), None,
        ),
        # three (…, A, K) tensors, actions, gripper logits, the loss; ~30 flops a component
        # (the function's bound: the gradients the kernel also writes are the backward's work)
        "mixture_nll_fwd": (nll_fwd(mixture_nll, True), nll_fwd(mixture_nll_plain, True),
                            bound(12 * n_comp + small, 30 * n_comp), None),
        "mixture_nll_fwd_no_grad": (nll_fwd(mixture_nll, False), nll_fwd(mixture_nll_plain, False),
                                    bound(12 * n_comp + small, 30 * n_comp), None),
        # the inputs and three gradients of their size; ~40 flops a component
        "mixture_nll_bwd": (lambda: torch.autograd.grad(k_nll, k_nll_leaves, inp.nll_weight, retain_graph=True),
                            lambda: torch.autograd.grad(p_nll, p_nll_leaves, inp.nll_weight, retain_graph=True),
                            bound(24 * n_comp + small + 8 * rows, 40 * n_comp), None),
        # post, prior, uniforms in, sample out: 16 bytes a logit; the KL out, 4 bytes a
        # sample; ~14 operations a logit (the Gumbel transform's four among them)
        "plan_st_kl_fwd": (plan_fwd(True), plan_fwd(False), bound(16 * n_plan + 4 * len(inp.kl_weight), 14 * n_plan),
                           None),
        # post, prior, d_sample in, two gradients out; ~15 flops a logit
        "plan_st_kl_bwd": (plan_bwd(k_st, k_kl, k_plan_leaves), plan_bwd(p_st, p_kl, p_plan_leaves),
                           bound(20 * n_plan + 4 * len(inp.kl_weight), 15 * n_plan), None),
        # the optimizer tail, B.5 and B.7: p, g, p' fp32 and m, v, m', v' bf16, 20 bytes,
        # ~14 flops a param (the update, g^2 for the norm); 8 bytes of partials a block
        "adam_lowp": (lambda: adam_lowp_update(ps, inp.adam_grads, ms, vs, 0.9, 0.999, 1e-8, -2e-4, c1, c2, table),
                      adam_plain, bound(20 * n_params + 8 * n_blocks, 14 * n_params), library_tail),
        # B.7's own launch, the finish: the partials to the norm, 8 bytes and one add a
        # partial (its squares ride in the Adam pass, timed in the row above); the plain
        # version sums the same partials on the card. No one PyTorch call takes partials
        "grad_norm": (lambda: grad_norm_finish(partials), lambda: partials.sum().sqrt().float(),
                      bound(8 * n_blocks + 4, n_blocks), None),
    }
    # these timed calls launch nothing else; hold the profiler to every launch
    one_launch = {"spatial_softmax_train", "mixture_nll_fwd", "mixture_nll_fwd_no_grad", "mixture_nll_bwd"}
    # the finish launch and the plan kernels are short, and the profiler drops some of their
    # launches: time per recorded launch
    per_recorded = {"grad_norm", "plan_st_kl_fwd", "plan_st_kl_bwd"}
    out = {"launch_floor": {"ms": device_ms(lambda: kernels.EMPTY_LAUNCH(inp.actions.device), 100, 1)}}
    for name, (kernel_fn, plain_fn, (bound_ms, bound_by), library_fn) in cases.items():
        iters, launches, rec = 20, 1 if name in one_launch | per_recorded else None, name in per_recorded
        ms_ = [device_ms(plain_fn, iters), device_ms(kernel_fn, iters, launches, rec),
               device_ms(kernel_fn, iters, launches, rec), device_ms(plain_fn, iters)]
        out[name] = {
            "ms": min(ms_[1], ms_[2]), "plain_ms": min(ms_[0], ms_[3]),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": device_ms(library_fn, iters) if library_fn is not None else None,
            "call_ms": call_ms(kernel_fn, iters), "plain_call_ms": call_ms(plain_fn, iters),
        }
    out["spatial_softmax_train"]["shape"] = list(inp.conv_map.shape)
    # B.4 by CUDA events too (the profiler drops some of its short launches); the backward
    # also through a loss (with its two eager products' backward), as it was first timed
    out["plan_st_kl_fwd"]["event_ms"] = event_ms(plan_fwd(True))
    out["plan_st_kl_bwd"]["event_ms"] = event_ms(plan_bwd(k_st, k_kl, k_plan_leaves))
    out["plan_st_kl_bwd"]["through_loss_ms"] = device_ms(
        lambda: torch.autograd.grad(k_plan_loss, k_plan_leaves, retain_graph=True), 20)
    for name in ("plan_st_kl_fwd", "plan_st_kl_bwd"):
        out[name]["shape"] = list(grid)
    out["adam_lowp"].update(n_params=n_params, blocks=n_blocks)
    # B.7 as a function, the gradients to their norm (4 bytes and 2 flops a param): the eager
    # norm the port ran before, and get_total_norm; the port's cost of it is in adam_lowp's ms
    out["grad_norm"].update(
        n_params=n_params, partials=n_blocks, norm_bound_ms=bound(4 * n_params, 2 * n_params)[0],
        norm_plain_ms=device_ms(lambda: global_norm(inp.adam_grads), 20),
        norm_library_ms=device_ms(lambda: torch.nn.utils.get_total_norm(inp.adam_grads), 20),
    )
    return out


# --------------------------------------------------------------------------
# training: the main path and the plain path
# --------------------------------------------------------------------------


TRAIN_KERNELS = (
    "hulc_preprocess_rgb_shift", "hulc_spatial_softmax", "hulc_spatial_softmax_bwd", "hulc_mixture_nll_fwd",
    "hulc_mixture_nll_bwd", "hulc_plan_st_kl_fwd", "hulc_plan_st_kl_bwd", "hulc_adam_lowp", "hulc_grad_norm_finish",
    "hulc_rnn_relu_fwd", "hulc_rnn_relu_bwd",
)


def drive_training(trainer, batch, kl_beta, steps):
    """``steps`` Trainer.train_step calls; returns (losses per step, host ms
    per step, device-event ms per step), each step ended by a sync."""
    losses, host, events = [], [], []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = trainer.train_step(batch, kl_beta)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
        losses.append({k: float(v) for k, v in out.items()})
    return losses, host, events


def train_step_grads(cfg, seed, device, state_dict, batch, shifts, depth_noise, plan_noise, use_kernels,
                     benchmark=False, trainer=None):
    """(losses, gradients by name) of one step from ``state_dict`` on the
    shifts, the depth noise (None: no depth camera), the plan noise
    ``plan_noise`` ({"gumbel": ...} or {"normal": ...}) and the trainer's
    generator at its seed (the dropout masks it draws), with
    cuDNN deterministic or, with ``benchmark``, on the algorithms it times
    fastest; on ``trainer`` (built with ``use_kernels``, its state
    initialized) when given, as the gradients depend on the weights and
    the inputs alone."""
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = not benchmark, benchmark
    if trainer is None:
        trainer = Trainer(cfg, TrainerConfig(seed=seed), device, use_kernels=use_kernels)
        trainer.init_state(1)
    trainer.model.load_state_dict(state_dict)
    trainer.generator.manual_seed(seed + 1)  # the same dropout masks on every path (phase 19)
    losses = trainer.train_step(batch, cfg.loss.kl_beta, shifts=shifts, depth_noise=depth_noise, **plan_noise)
    # a parameter no loss reaches (GCBC's recognition head) has no gradient: zeros, as JAX's
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
             for k, p in trainer.model.named_parameters()}
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False
    return losses, grads


@contextlib.contextmanager
def ulp_noise(module, name, seed, bf16_share=None):
    """``module.name``, a plain version the use_kernels=False path calls,
    with each output moved one ulp up or down at random: an ulp-level change
    at a point where a kernel's result differs from the plain one's (the
    SpatialSoftmax forward by up to ~1 ulp; the BiRNN's layers, B.9, by a
    few). With ``bf16_share`` (a bf16 model), that share of the outputs, at
    random, moves one bf16 ulp instead, so that it rounds one step away at
    the next layer's bf16 input: the share of keypoints whose rounding B.2's
    kernel moves (measured in the run; its keypoints sit a few fp32 ulps
    from the plain ones, many ulps of a small keypoint)."""
    plain = getattr(module, name)
    setattr(module, name, noisy(plain, seed, bf16_share))
    try:
        yield
    finally:
        setattr(module, name, plain)


def noisy(fn, seed, bf16_share=None):
    """``fn`` with its output (a tensor, or the first of a tuple) moved as
    ``ulp_noise`` says."""

    def move(out):
        gen = torch.Generator(device=out.device).manual_seed(seed)
        up = torch.rand(out.shape, generator=gen, device=out.device) < 0.5
        if bf16_share is not None:
            picked = torch.rand(out.shape, generator=gen, device=out.device) < bf16_share
            _, exp = torch.frexp(out.detach())
            bf16_ulp = torch.ldexp(torch.ones_like(out), exp - 8)  # 8 significant bits
            return out + torch.where(picked, torch.where(up, bf16_ulp, -bf16_ulp), 0.0)
        away = torch.where(up, torch.full_like(out, float("inf")), torch.full_like(out, float("-inf")))
        return out + (torch.nextafter(out.detach(), away) - out.detach())

    def wrapped(*args):
        out = fn(*args)
        return (move(out[0]), *out[1:]) if isinstance(out, tuple) else move(out)

    return wrapped


def noisy_input(fn, seed):
    """``fn`` with its first argument moved one ulp up or down at random
    (``noisy``'s move), its output as it is."""
    move = noisy(lambda t: t, seed)

    def wrapped(x, *rest):
        return fn(move(x), *rest)

    return wrapped


@contextlib.contextmanager
def plain_recurrence(cell, wrap):
    """``layers.RECURRENCES[cell]``'s plain loop replaced by ``wrap(plain)``."""
    from hulc_tpu_torch.models import layers

    kernel, plain = layers.RECURRENCES[cell]
    layers.RECURRENCES[cell] = (kernel, wrap(plain))
    try:
        yield
    finally:
        layers.RECURRENCES[cell] = (kernel, plain)


def feeds_bf16(call, num_layers):
    """Whether call ``call`` (from 0) of a ``num_layers``-layer ScanRNN's
    recurrence is a layer whose output the next layer's bf16 input
    projection rounds (every layer but the last: its output goes to the
    fp32 heads)."""
    return call % num_layers < num_layers - 1


@contextlib.contextmanager
def recurrence_flips(cell, num_layers):
    """The plain recurrence of ``cell``, unchanged, counting where its
    kernel rounds differently: each call of a layer that ``feeds_bf16``
    also runs the kernel on the same inputs, and {"flipped", "outputs"}
    counts the outputs whose bf16 value differs from the plain loop's (the
    kernel's own share of bf16 rounding flips, as ``check_bf16_kernels``
    measures B.2's). Those kernel launches are not the main path's."""
    from hulc_tpu_torch.models import layers

    kernel = layers.RECURRENCES[cell][0]
    counts, calls = {"flipped": 0, "outputs": 0}, itertools.count()

    def wrap(plain):
        def probed(x_proj, *rest):
            out = plain(x_proj, *rest)
            if feeds_bf16(next(calls), num_layers):
                *state, w_hh, b_hh = rest
                with torch.no_grad():
                    got = kernel(x_proj, *(s.contiguous() for s in state), w_hh, b_hh)[0]
                want = out[0] if isinstance(out, tuple) else out
                counts["flipped"] += int((got.to(torch.bfloat16) != want.to(torch.bfloat16)).sum())
                counts["outputs"] += want.numel()
            return out
        return probed

    with plain_recurrence(cell, wrap):
        yield counts


@contextlib.contextmanager
def recurrence_noise(cell, num_layers, seed, bf16_share):
    """The plain recurrence of ``cell`` with the outputs of each layer that
    ``feeds_bf16`` moved as ``ulp_noise`` moves the keypoints, at
    ``bf16_share`` (the recurrence kernel's own share, ``recurrence_flips``),
    each call at its own random positions; the last layer's outputs as they
    are."""
    calls = itertools.count()

    def wrap(plain):
        def moved(*args):
            i = next(calls)
            return noisy(plain, seed * 4096 + i, bf16_share)(*args) if feeds_bf16(i, num_layers) else plain(*args)
        return moved

    with plain_recurrence(cell, wrap):
        yield


class _GradUlp(torch.autograd.Function):
    """The identity, whose backward moves each entry of the incoming
    gradient one ulp up or down at random (``seed``)."""

    @staticmethod
    def forward(ctx, x, seed):
        ctx.seed = seed
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        gen = torch.Generator(device=g.device).manual_seed(ctx.seed)
        up = torch.rand(g.shape, generator=gen, device=g.device) < 0.5
        away = torch.where(up, torch.full_like(g, float("inf")), torch.full_like(g, float("-inf")))
        return torch.nextafter(g, away), None


@contextlib.contextmanager
def kl_grad_noise(seed):
    """The plain plan's balanced KL with the gradient into each logit, of
    the posterior and of the prior, moved one ulp at random: B.4's backward
    kernel sums each logit's gradient in another order than autograd
    through the plain KL, and a bf16 model's proposal and recognition
    networks round that gradient to bf16 on the way back."""
    from hulc_tpu_torch.ops.plan_distributions import DiscretePlanState, PlanDistribution

    plain = PlanDistribution.balanced_kl
    calls = itertools.count()

    def moved(self, posterior, prior, alpha, per_sample=False):
        if isinstance(posterior, DiscretePlanState):
            posterior = DiscretePlanState(_GradUlp.apply(posterior.logit, seed * 4096 + next(calls)))
            prior = DiscretePlanState(_GradUlp.apply(prior.logit, seed * 4096 + next(calls)))
        return plain(self, posterior, prior, alpha, per_sample)

    PlanDistribution.balanced_kl = moved
    try:
        yield
    finally:
        PlanDistribution.balanced_kl = plain


def separate_plan_ties(model, cfg, batch, shifts, depth_noise, gumbel):
    """The plan noise with every near tie of the posterior's pick pulled
    apart: where the top two of gumbel + logits are closer than
    PLAN_TIE_MARGIN, the leader's noise grows by the margin. Float noise
    between the two paths (~1e-6 in the logits) then cannot flip a pick, and
    a flipped pick would change that window's decoder input and its
    gradients outright. Returns (noise, number of ties pulled apart)."""
    from hulc_tpu_torch.training.preprocess import preprocess_batch

    with torch.no_grad():
        prep = preprocess_batch(cfg, batch, train=True, shifts=shifts, depth_noise=depth_noise)["fused"]
        emb, _ = model.encode(prep.rgb_obs(), prep.robot_obs, prep.depth_obs())
        state, _ = model.plan_recognition(emb)
        top = (gumbel + state.logit.reshape(gumbel.shape)).topk(2, dim=-1)
    near = (top.values[..., 0] - top.values[..., 1]) < PLAN_TIE_MARGIN
    gumbel = gumbel.clone()
    gumbel.scatter_add_(-1, top.indices[..., :1], PLAN_TIE_MARGIN * near[..., None].to(gumbel.dtype))
    return gumbel, int(near.sum())


def compare_train_plain(cfg, model, batch, seed, device="cuda", label="train plain path", bf16_share=None,
                        patterns=ULP_PATTERNS):
    """One step from the same params, batch, shifts, depth noise and plan
    noise through the kernel path and the plain path (recognition dropout 0, cuDNN
    deterministic, a discrete plan's ties pulled apart); losses per key and
    gradients per parameter must agree.

    Each gradient is held to STEP_GRAD_REL (relative L2), or to NOISE_FACTOR
    times its own sensitivity to the SpatialSoftmax forward, to the relu
    decoder recurrence (B.6) and, in a model with a BiRNN, to its layers'
    outputs, whichever is larger. The
    kernel's keypoints differ from the plain ones by up to about an ulp (the
    BiRNN's outputs by a few), and relu units downstream that sit within an
    ulp of zero then switch: that moves some gradients by a few 1e-4 (the
    backward kernels alone move them by about 1e-5). The sensitivity is
    measured in the run, as the plain path's own gradient change when each
    keypoint, each input of the relu decoder recurrence (its input
    projection) and each BiRNN output moves one ulp at random
    (``ulp_noise``, ``noisy_input``),
    the largest over ULP_PATTERNS random patterns: which relu units switch,
    and so how far a gradient moves, depends on the pattern (on the mcil
    step, 8 of 10 patterns moved the camera towers' gradients by
    1.5e-4-1.6e-4 and 2 by 3.6e-4 and 5.3e-4, one of them reproducing the
    kernel path's own differences leaf by leaf). Each parameter's largest
    change over the patterns sets its limit. Each loss is held to
    STEP_LOSS_RTOL; with ``bf16_share`` (a bf16 model: the keypoints' noise,
    ``ulp_noise``) to the larger of that and NOISE_FACTOR x its own
    sensitivity, measured the same way. The recurrence's inputs are moved
    because B.6's kernel sums each pre-activation in another order than
    the plain loop, so a relu unit within an ulp of zero can switch inside
    the recurrence, forward and backward; moving its outputs instead misses
    that (on ``hulc_state_only``, which has no keypoints to move, the
    inputs' ulp moved the language goal's gradients by 2.1e-4, as the
    kernel does, the outputs' by 3.9e-7). A model whose decoder runs no
    relu recurrence (gru, lstm, mlp) calls no B.6 to move. Shifts are drawn for
    the config's cameras (a tactile tower's with its branch's pad); GCBC
    draws no plan noise. ``patterns`` (fewer for the frozen CLIP and
    tactile towers, whose steps are long: the time the patterns took is
    printed) sets how many noise patterns measure the sensitivity: fewer
    can only lower a limit. In a bf16 model (``bf16_share`` given) each
    pattern also moves the relu recurrence's outputs that a bf16 input
    projection reads next by one bf16 ulp, at the share of them whose bf16
    rounding B.6's kernel moves on this step (``recurrence_flips``,
    measured in a plain step; ``recurrence_noise``), and the plan KL's
    gradients into the logits by one ulp (``kl_grad_noise``: B.4's backward
    kernel), as both kernels move them in every bf16 model."""
    from hulc_tpu_torch.models import layers, vision
    from hulc_tpu_torch.ops.image_ops import draw_shifts
    from hulc_tpu_torch.ops.plan_distributions import gumbel_noise
    from hulc_tpu_torch.training.preprocess import CAMERAS, train_shift_pad
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    cfg0 = dataclasses.replace(cfg, plan_recognition=dataclasses.replace(cfg.plan_recognition, dropout=0.0))
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    fused = batch["fused"]
    n, s = fused.actions.shape[:2]
    pe, d = cfg.perceptual_encoder, cfg.distribution
    shifts = {"fused": {cam: draw_shifts(n * s, train_shift_pad(getattr(pe, field)), gen, device)
                        for cam, field in CAMERAS
                        if getattr(pe, field) is not None and getattr(fused, cam) is not None}}
    depth = {cam: torch.randn(getattr(fused, cam).shape, generator=gen, device=device)
             for cam in ("depth_static", "depth_gripper") if getattr(pe, cam) is not None}
    depth_noise = {"fused": depth} if depth else None
    if cfg.model_kind == "gcbc":
        plan_noise, ties, ties_txt = {}, 0, "GCBC: no plan"
    elif d.kind == "discrete":
        gumbel, ties = separate_plan_ties(
            model, cfg, batch, shifts, depth_noise, gumbel_noise((n, d.category_size, d.class_size), gen, device)
        )
        plan_noise = {"gumbel": gumbel}
        ties_txt = f"{ties} plan ties of {n * d.category_size} pulled apart by {PLAN_TIE_MARGIN}"
    else:
        plan_noise, ties = {"normal": torch.randn((n, d.plan_features), generator=gen, device=device)}, 0
        ties_txt = "a continuous plan: no ties"
    state = {k: v.clone() for k, v in model.state_dict().items()}
    args = (cfg0, seed, device, state, batch, shifts, depth_noise, plan_noise)
    lk, gk = train_step_grads(*args, use_kernels=True)
    ad = cfg.action_decoder
    share = None
    if bf16_share is not None:
        with recurrence_flips("rnn", ad.num_layers) as flips:
            lp, gp = train_step_grads(*args, use_kernels=False)
        share = flips["flipped"] / max(flips["outputs"], 1)
        print(f"[{label}] B.6's kernel rounds {flips['flipped']} of {flips['outputs']} recurrence outputs to another "
              f"bf16 value than the plain loop ({share:.3g})")
    else:
        lp, gp = train_step_grads(*args, use_kernels=False)

    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in gp.values())))
    live = []
    for k in gp:
        if float(gp[k].norm()) > ZERO_GRAD * total:
            live.append(k)
        elif not float(gk[k].norm()) <= ZERO_GRAD * total:
            # zero in exact arithmetic (the attention's key bias: a constant
            # added to every key of a query cancels in its softmax)
            fail(f"train step: {k}'s gradient should be rounding noise on both paths")
    errs = {k: rel_l2(gk[k], gp[k]) for k in live}
    sens, loss_sens = dict.fromkeys(live, 0.0), dict.fromkeys(lp, 0.0)
    plain = Trainer(cfg0, TrainerConfig(seed=seed), device, use_kernels=False)
    plain.init_state(1)
    t_patterns = time.perf_counter()
    for i in range(patterns):
        with ulp_noise(vision, "spatial_softmax_plain", seed + 13 + 2 * i, bf16_share), \
                ulp_noise(layers, "birnn_layer_plain", seed + 14 + 2 * i), \
                plain_recurrence("rnn", functools.partial(noisy_input, seed=seed + 15 + 2 * i)), \
                (recurrence_noise("rnn", ad.num_layers, seed + 16 + 2 * i, share) if share is not None
                 else contextlib.nullcontext()), \
                (kl_grad_noise(seed + 17 + 2 * i) if share is not None else contextlib.nullcontext()):
            lu, gu = train_step_grads(*args, use_kernels=False, trainer=plain)
        sens = {k: max(v, rel_l2(gu[k], gp[k])) for k, v in sens.items()}
        loss_sens = {k: max(v, abs(float(lu[k]) - float(lp[k])) / max(abs(float(lp[k])), 1e-30))
                     for k, v in loss_sens.items()}
    pattern_s = time.perf_counter() - t_patterns
    del plain
    # each loss within STEP_LOSS_RTOL; in bf16, or NOISE_FACTOR x its own sensitivity (a keypoint
    # an ulp away can round the other way at the next layer's input and move a loss by ~1e-5)
    loss_err = 0.0
    for k in lp:
        rel = abs(float(lk[k]) - float(lp[k])) / max(abs(float(lp[k])), 1e-30)
        rtol = STEP_LOSS_RTOL if bf16_share is None else max(STEP_LOSS_RTOL, NOISE_FACTOR * loss_sens[k])
        if not torch.allclose(lk[k], lp[k], rtol=rtol, atol=1e-7):
            fail(f"train step: {k} differs between kernel path {float(lk[k])} and plain path {float(lp[k])} "
                 f"(relative {rel}; its sensitivity to the keypoints' noise {loss_sens[k]})")
        loss_err = max(loss_err, rel)
    limits = {k: max(STEP_GRAD_REL, NOISE_FACTOR * sens[k]) for k in live}
    worst, closest = max(live, key=errs.get), max(live, key=lambda k: errs[k] / limits[k])
    if not errs[closest] <= limits[closest]:
        fail(f"train step: {closest}'s gradient differs from the plain path's by relative L2 {errs[closest]}, "
             f"limit {limits[closest]} (its sensitivity to one ulp of the keypoints, the decoder recurrence's "
             f"inputs and the BiRNN outputs "
             f"{sens[closest]})")
    print(f"[{label}] one step agrees with use_kernels=False on the card ({ties_txt}): losses within relative "
          f"{loss_err:.3g} "
          f"(rtol {STEP_LOSS_RTOL}{'' if bf16_share is None else f', or {NOISE_FACTOR} x each loss sensitivity'}; "
          f"sensitivity up to {max(loss_sens.values()):.3g}); gradients of {len(live)} tensors within relative L2 {errs[worst]:.3g} "
          f"({worst}), {sum(e > STEP_GRAD_REL for e in errs.values())} above {STEP_GRAD_REL}; each tensor's "
          f"limit is the larger of {STEP_GRAD_REL} and {NOISE_FACTOR} x how far the plain path moves it when each "
          f"keypoint moves one ulp{'' if bf16_share is None else f' (a {bf16_share:.3g} share one bf16 ulp)'} (and each "
          f"decoder recurrence input and BiRNN output one ulp), over "
          f"{patterns} random patterns (up to "
          f"{max(sens.values()):.3g}; the patterns took {pattern_s:.2f} s, {pattern_s / max(patterns, 1):.3f} s each); "
          f"closest to its limit: {closest} at {errs[closest]:.3g} of "
          f"{limits[closest]:.3g}")
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"loss_rel_err": loss_err, "loss_ulp_sensitivity": max(loss_sens.values()),
            "grad_rel_err": errs[worst], "ulp_sensitivity": max(sens.values()),
            "closest_to_limit": {"tensor": closest, "rel_err": errs[closest], "limit": limits[closest]},
            "plan_ties": ties, "patterns": patterns, "patterns_s": pattern_s}


# --------------------------------------------------------------------------
# phase 12: the training loop
# --------------------------------------------------------------------------

FIT_EPISODES, FIT_EPISODE_LEN = 4, 64  # the training split; validation gets half the episodes
FIT_BATCH, FIT_STEPS_PER_EPOCH, FIT_EPOCHS, FIT_VAL_BATCHES = 32, 3, 2, 2
VAL_REL = 1e-4  # val step, kernel path vs plain path: each loss and MAE, relative
# the JAX package's validation keys (hulc_tpu/models/hulc.py val_metrics, scalars only)
VAL_KEYS = sorted(
    [f"{scope}_{name}" for scope in ("vis", "lang") for name in (
        "action_loss_pp", "action_loss_pr", "kl_loss", "gripper_sr_pp", "gripper_sr_pr", "mae_pp", "mae_pr",
        "pos_mae_pp", "pos_mae_pr", "orn_mae_pp", "orn_mae_pr",
    )] + ["val_pred_clip_loss", "action_loss_pp"]
)
# the kernels one val step launches, per modality: B.1 for both cameras, B.2
# for the static camera, and per decoded window (two: the proposal's and the
# recognition's plan) B.3, B.3' forward and B.6 forward for both layers
VAL_LAUNCHES_PER_MODALITY = {
    "hulc_preprocess_rgb": 2, "hulc_spatial_softmax": 1, "hulc_logistic_mixture_sample": 2,
    "hulc_mixture_nll_fwd": 2, "hulc_rnn_relu_fwd": 4,
}
LOOP_BATCHES, LOOP_WORKERS = 12, (1, 4)  # the timed loop's epoch and its assembly workers
SHM_GATHER_THREADS = 4  # C++ threads of one shm gather
# the upload check: fused batches uploaded back to back (each of the two
# staging slots staged twice) behind this much device spin on the copy stream
UPLOAD_CHECK_BATCHES, UPLOAD_SPIN_S = 4, 0.05


def long_epoch(loaders, batches, workers):
    """A fused CombinedLoader over ``loaders`` whose epoch is ``batches``
    batches of random windows (drawn with replacement, as every epoch is)."""
    from hulc_tpu_torch.data.loader import CombinedLoader

    class Epoch(CombinedLoader):
        def __len__(self):
            return batches

    return Epoch(loaders, num_workers=workers, fuse=True)


class FirstBatches:
    """The first ``n`` batches of ``loader`` as its epoch."""

    def __init__(self, loader, n):
        self.loader, self.n = loader, n

    def __len__(self):
        return self.n

    def __iter__(self):
        return itertools.islice(iter(self.loader), self.n)


def launch_counts():
    from hulc_tpu_torch import kernels

    return {k.symbol: k.launches for k in kernels.ALL_KERNELS}


def count_validation(trainer, launches, calls):
    """Wrap ``trainer.validate`` so that the launches it makes add up in
    ``launches`` and each call's means go to ``calls``."""
    validate = trainer.validate

    def counted(*args, **kwargs):
        before = launch_counts()
        out = validate(*args, **kwargs)
        launches.update({s: n - before[s] for s, n in launch_counts().items()})
        calls.append(out)
        return out

    trainer.validate = counted


def sampled_dims(cfg):
    """The action dimensions the mixture samples: all but a discrete gripper."""
    ad = cfg.action_decoder
    return ad.out_features - 1 if ad.discrete_gripper else ad.out_features


def plan_noise_of(noise, tag):
    """The plan draw's keyword of a val noise dict: gumbel_{tag} or normal_{tag}."""
    return {k: noise[f"{k}_{tag}"] for k in ("gumbel", "normal") if f"{k}_{tag}" in noise}


def val_noise(cfg, b, s, gen):
    """One modality's validation noise (``models.hulc.VAL_NOISE_KEYS``):
    Gumbel noise (a discrete plan) or a standard-normal draw (a continuous
    one) for both plans, mixture uniforms in (U_MIN, U_MAX) for both
    decoded windows; only the draws the model makes (GCBC decodes one
    window from its empty plan, the deterministic decoder samples nothing)."""
    from hulc_tpu_torch.ops.logistic_mixture import U_MIN, U_SPAN
    from hulc_tpu_torch.ops.plan_distributions import gumbel_noise

    d, ad = cfg.distribution, cfg.action_decoder
    shape = (b, s, sampled_dims(cfg), ad.n_mixtures)
    gcbc = cfg.model_kind == "gcbc"
    out = {}
    for tag in ("pp",) if gcbc else ("pp", "pr"):
        if gcbc:
            pass
        elif d.kind == "discrete":
            out[f"gumbel_{tag}"] = gumbel_noise((b, d.category_size, d.class_size), gen, "cuda")
        else:
            out[f"normal_{tag}"] = torch.randn((b, d.plan_features), generator=gen, device="cuda")
        if ad.kind == "logistic":
            out[f"u_mix_{tag}"] = U_MIN + U_SPAN * torch.rand(shape, generator=gen, device="cuda")
            out[f"u_inv_{tag}"] = U_MIN + U_SPAN * torch.rand(shape[:-1], generator=gen, device="cuda")
    return out


def pull_apart(noise, scores):
    """Where the top two of ``noise + scores`` (last axis) are closer than
    PLAN_TIE_MARGIN, grow the leader's noise by the margin, in place;
    returns the number of ties pulled apart."""
    top = (noise + scores).topk(2, dim=-1)
    near = (top.values[..., 0] - top.values[..., 1]) < PLAN_TIE_MARGIN
    noise.scatter_add_(-1, top.indices[..., :1], PLAN_TIE_MARGIN * near[..., None].to(noise.dtype))
    return int(near.sum())


def separate_val_ties(model, batch, noise):
    """The val step's noise with every near tie pulled apart, from the
    plain model's scores: each plan's pick (its Gumbel noise) and each
    decoded window's mixture pick (its uniforms, through their Gumbel
    transform -log(-log u)), as separate_plan_ties does for the train
    step. Float noise between the two paths then cannot flip a pick.
    Returns (plan ties, mixture ties) pulled apart."""
    plan_ties = mix_ties = 0
    with torch.no_grad():
        for scope, mod in batch.items():
            n = noise[scope]
            emb, _ = model.encode(mod.rgb_obs(), mod.robot_obs, mod.depth_obs())
            goal = model.encode_language_goal(mod.lang) if "lang" in scope else model.encode_visual_goal(emb[:, -1])
            if model.gcbc:
                states = {"pp": None}
            else:
                states = {"pp": model.plan_proposal(emb[:, 0], goal), "pr": model.plan_recognition(emb)[0]}
            for tag, state in states.items():
                if f"gumbel_{tag}" in n:
                    g = n[f"gumbel_{tag}"]
                    plan_ties += pull_apart(g, state.logit.reshape(g.shape))
                if f"u_mix_{tag}" not in n:  # the deterministic decoder: no pick
                    continue
                plan = model.empty_plan(emb.shape[0]) if state is None else model.dist.sample(
                    state, **plan_noise_of(n, tag))
                logit_probs = model.action_decoder(plan, emb, goal).logit_probs
                gm = -torch.log(-torch.log(n[f"u_mix_{tag}"]))
                mix_ties += pull_apart(gm, logit_probs)
                n[f"u_mix_{tag}"] = torch.exp(-torch.exp(-gm))
    return plan_ties, mix_ties


def check_window_kernels(model, batch, noise, label="training loop"):
    """The decoder cell's recurrence forward (B.6; B.11 or B.12 for a gru or
    lstm decoder), B.3 and B.3''s forward at the val step's window shapes
    on the val step's own inputs (``model`` is the plain path's, ``noise``
    the val step's with its near ties pulled apart): for each modality and
    each plan source, each decoder layer's recurrence from a zero carry
    within REC_REL (relative L2) of the plain loop; the sampled window
    within atol 1e-5 of the plain sampler with a bit-equal gripper column
    and, at u_inv = 0.5 (each entry then its picked component's mean),
    bit-equal, so the picks are the same; the per-frame NLL under no_grad
    within LOSS_RTOL per entry. Returns the largest errors."""
    from hulc_tpu_torch.ops.frame_transforms import world_to_tcp_frame
    from hulc_tpu_torch.ops.logistic_mixture import mixture_nll, mixture_nll_plain, sample_action, sample_action_plain
    from hulc_tpu_torch.models.layers import RECURRENCES, input_projection

    dec = model.action_decoder
    c, rnn = dec.cfg, dec.rnn
    kernel_fn, plain_fn = RECURRENCES[rnn.cell]
    kernel_row = {"rnn": "B.6", "gru": "B.11", "lstm": "B.12"}[rnn.cell]
    bounds, (amin, amax) = (c.act_min_bound[-1], c.act_max_bound[-1]), dec._bounds()
    errs = {"rnn_rel_l2": 0.0, "sample_max_abs": 0.0, "nll_max_abs": 0.0}
    shapes = set()
    rnn_inputs = []
    hook = rnn.register_forward_hook(lambda mod, args, out: rnn_inputs.append(args[0]))
    try:
        with torch.no_grad():
            for scope, mod in batch.items():
                n = noise[scope]
                emb, _ = model.encode(mod.rgb_obs(), mod.robot_obs, mod.depth_obs())
                goal = model.encode_language_goal(mod.lang) if "lang" in scope else model.encode_visual_goal(emb[:, -1])
                states = {"pp": model.plan_proposal(emb[:, 0], goal), "pr": model.plan_recognition(emb)[0]}
                actions = world_to_tcp_frame(mod.actions, mod.state_info_robot_obs) if c.gripper_control else mod.actions
                for tag, state in states.items():
                    where = f"the val step's {scope} window ({tag} plan)"
                    rnn_inputs.clear()
                    out = dec(model.dist.sample(state, **plan_noise_of(n, tag)), emb, goal)
                    x = rnn_inputs[0]
                    for k in range(rnn.num_layers):
                        w_ih, b_ih = getattr(rnn, f"weight_ih_l{k}"), getattr(rnn, f"bias_ih_l{k}")
                        xp = input_projection(rnn.dtype, x, w_ih, b_ih)
                        w, bias = getattr(rnn, f"weight_hh_l{k}"), getattr(rnn, f"bias_hh_l{k}")
                        zeros = (xp.new_zeros(xp.shape[0], w.shape[1]),) * (2 if rnn.cell == "lstm" else 1)
                        got = kernel_fn(xp, *zeros, w, bias)[0]
                        x = plain_fn(xp, *zeros, w, bias)
                        x = x[0] if rnn.cell == "lstm" else x
                        if not rel_l2(got, x) <= REC_REL:
                            fail(f"recurrence forward kernel at {where}, layer {k} {tuple(xp.shape)}: "
                                 f"relative L2 {rel_l2(got, x)}")
                        errs["rnn_rel_l2"] = max(errs["rnn_rel_l2"], rel_l2(got, x))
                        shapes.add((kernel_row, tuple(xp.shape)))
                    grip = out.gripper_logits if c.discrete_gripper else None
                    params = (out.logit_probs, out.log_scales, out.means)
                    u = (n[f"u_mix_{tag}"], n[f"u_inv_{tag}"])
                    got = sample_action(*params, *u, grip, bounds, (0.0, 1.0))
                    want = sample_action_plain(*params, *u, grip, bounds, (0.0, 1.0))
                    a = out.means.shape[-2]
                    if grip is not None and not torch.equal(got[..., a], want[..., a]):
                        fail(f"mixture sample kernel at {where}: the gripper column differs")
                    if not torch.allclose(got, want, rtol=0, atol=1e-5):
                        fail(f"mixture sample kernel at {where}: max abs err {max_abs(got, want)}")
                    half = torch.full_like(u[1], 0.5)
                    if not torch.equal(sample_action(*params, u[0], half, grip, bounds, (0.0, 1.0)),
                                       sample_action_plain(*params, u[0], half, grip, bounds, (0.0, 1.0))):
                        fail(f"mixture sample kernel picked other components than the plain version at {where}")
                    errs["sample_max_abs"] = max(errs["sample_max_abs"], max_abs(got, want))
                    shapes.add(("B.3", tuple(out.means.shape)))
                    consts = (amin, amax, c.num_classes, c.log_scale_min, c.gripper_alpha)
                    got = mixture_nll(*params, actions, grip, *consts)
                    want = mixture_nll_plain(*params, actions, grip, *consts)
                    if got.grad_fn is not None or not torch.allclose(got, want, rtol=LOSS_RTOL, atol=0):
                        fail(f"mixture NLL forward kernel under no_grad at {where}: max abs err {max_abs(got, want)}")
                    errs["nll_max_abs"] = max(errs["nll_max_abs"], max_abs(got, want))
                    shapes.add(("B.3'", tuple(out.means.shape)))
    finally:
        hook.remove()
    print(f"[{label}] at the val step's window shapes {sorted(shapes)}, on its own inputs: the recurrence's "
          f"forward within relative L2 {errs['rnn_rel_l2']:.3g} of the plain loop (limit {REC_REL}), the sampled "
          f"windows within {errs['sample_max_abs']:.3g} (limit 1e-5) with bit-equal gripper columns and the same "
          f"picks, the NLL under no_grad within {errs['nll_max_abs']:.3g} max abs (rtol {LOSS_RTOL})")
    return errs


def compare_val_plain(cfg, trainer, seed, raw_batch, label="training loop", patterns=0, bf16_share=None):
    """One val step through the kernels against the same weights'
    use_kernels=False model, fed the same plan and sampler noise (near
    ties of both picks pulled apart): every loss and MAE within VAL_REL
    relative, the gripper success rates equal, the sampled plans equal (a
    continuous plan's within VAL_REL relative L2). With ``patterns`` (a
    bf16 model: a keypoint an ulp away can round the other way), each loss
    and MAE within the larger of VAL_REL and NOISE_FACTOR x the plain path's
    own change under ``ulp_noise`` of the keypoints (``bf16_share``; the
    largest over ``patterns`` patterns); success rates and plans as above.
    In a bf16 model the patterns also move the recurrence's outputs at
    B.6's own bf16 flip share, as ``compare_train_plain`` does."""
    from hulc_tpu_torch.models import make_model, vision
    from hulc_tpu_torch.training.preprocess import preprocess_batch

    plain = make_model(cfg, "cuda", seed=seed, use_kernels=False)
    plain.load_state_dict(trainer.model.state_dict())
    trainer.model.eval()
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    b, s = raw_batch["vis"].actions.shape[:2]
    noise = {scope: val_noise(cfg, b, s, gen) for scope in raw_batch}
    with torch.no_grad():
        prep_plain = preprocess_batch(cfg, raw_batch, train=False, use_kernels=False)
        ties, mix_ties = separate_val_ties(plain, prep_plain, noise)
        # the window kernels' own check: the RNN decoders of the plan models (phase 12's path)
        windows = cfg.model_kind != "gcbc" and cfg.action_decoder.kind == "logistic"
        window_errs = check_window_kernels(plain, prep_plain, noise, label) if windows else None
        layers_n = cfg.action_decoder.num_layers
        bf16 = bf16_share is not None
        with recurrence_flips("rnn", layers_n) if bf16 else contextlib.nullcontext({}) as flips:
            want = plain.val_metrics(prep_plain, cfg.loss.kl_beta, noise=noise)
        share = flips["flipped"] / max(flips["outputs"], 1) if bf16 else None
        got = trainer.model.val_metrics(preprocess_batch(cfg, raw_batch, train=False), cfg.loss.kl_beta, noise=noise)
        sens = {}
        for i in range(patterns):
            with ulp_noise(vision, "spatial_softmax_plain", seed + 41 + i, bf16_share), \
                    (recurrence_noise("rnn", layers_n, seed + 43 + i, share) if share is not None
                     else contextlib.nullcontext()):
                noisy = plain.val_metrics(prep_plain, cfg.loss.kl_beta, noise=noise)
            for k, v in noisy.items():
                if "sampled_plan" not in k and "gripper_sr" not in k:
                    sens[k] = max(sens.get(k, 0.0), abs(float(v) - float(want[k])) / max(abs(float(want[k])), 1e-30))
    trainer.model.train()
    if set(got) != set(want):
        fail(f"val step: the kernel and the plain path give different keys: {sorted(set(got) ^ set(want))}")
    worst = 0.0
    for k in sorted(want):
        g, w = got[k], want[k]
        if "sampled_plan" in k and cfg.distribution.kind == "continuous":
            if not rel_l2(g, w) <= VAL_REL:
                fail(f"val step: {k} differs between the kernel path and the plain path by relative L2 "
                     f"{rel_l2(g, w)}")
            worst = max(worst, rel_l2(g, w))
            continue
        if "sampled_plan" in k or "gripper_sr" in k:
            if not torch.equal(g, w):
                fail(f"val step: {k} differs between the kernel path and the plain path "
                     f"({int((g != w).sum())} entries; {ties} plan ties pulled apart)")
            continue
        rel = abs(float(g) - float(w)) / max(abs(float(w)), 1e-30)
        if not rel <= max(VAL_REL, NOISE_FACTOR * sens.get(k, 0.0)):
            fail(f"val step: {k} is {float(g)} on the kernel path and {float(w)} on the plain path (relative {rel}; "
                 f"its sensitivity to the keypoints' noise {sens.get(k, 0.0)})")
        worst = max(worst, rel)
    del plain
    torch.cuda.empty_cache()
    picks = 4 * b * s * sampled_dims(cfg)
    plans = (f"{ties} plan ties of {4 * b * cfg.distribution.category_size} and " if cfg.distribution.kind == "discrete"
             else "")
    noise_txt = (f"; each loss or MAE also within {NOISE_FACTOR} x its sensitivity: over {patterns} keypoint noise "
                 f"patterns the plain path moved one by up to {max(sens.values(), default=0.0):.3g}" if patterns else "")
    print(f"[{label}] one val step agrees with "
          f"use_kernels=False on the card: losses, MAEs (and a continuous plan) within relative {worst:.3g} (limit "
          f"{VAL_REL}), gripper success rates and discrete sampled plans equal ({plans}{mix_ties} mixture ties of "
          f"{picks} picks pulled apart by {PLAN_TIE_MARGIN}){noise_txt}")
    return {"max_rel_err": worst, "plan_ties": ties, "mixture_ties": mix_ties, "window_kernels": window_errs,
            "ulp_sensitivity": max(sens.values(), default=0.0)}


def check_window_preprocess(raw_batch, card):
    """B.1 at the val window shape (each modality's cameras): bit-equal to
    the plain version, and its device time against its bytes."""
    from hulc_tpu_torch.ops.image_ops import preprocess_rgb_seq, preprocess_rgb_seq_plain

    out = {}
    for cam in ("rgb_static", "rgb_gripper"):
        imgs = getattr(raw_batch["vis"], cam)
        got, want = preprocess_rgb_seq(imgs), preprocess_rgb_seq_plain(imgs)
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"preprocess kernel at the window shape {tuple(imgs.shape)} is not bit-equal: "
                 f"max abs err {max_abs(got, want)}")
        del got, want
        nbytes = imgs.numel() * (1 + 4)  # uint8 in, fp32 out
        t = {"shape": list(imgs.shape), "max_abs_err": 0.0, "in_mb": imgs.numel() / 1e6,
             "out_mb": 4 * imgs.numel() / 1e6}
        # late in a long process the profiler drops some launches: the time is per recorded launch
        t["ms"] = device_ms(lambda: preprocess_rgb_seq(imgs), 20, launches_per_call=1, per_recorded=True)
        t["plain_ms"] = device_ms(lambda: preprocess_rgb_seq_plain(imgs), 5)
        t["bound_ms"], t["bound_by"] = bound(nbytes, 0)
        t["call_ms"] = call_ms(lambda: preprocess_rgb_seq(imgs), 20)
        t["plain_call_ms"] = call_ms(lambda: preprocess_rgb_seq_plain(imgs), 5)
        t["library_ms"] = None
        t["hbm_gb_per_s"] = nbytes / t["ms"] / 1e6
        print(f"[training loop] B.1 at the window shape {tuple(imgs.shape)} u8: bit-equal to the plain version; "
              f"device time {t['ms']:.6f} ms against its bound {t['bound_ms']:.6f} ms ({t['in_mb']:.1f} MB in + "
              f"{t['out_mb']:.1f} MB out at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), {100 * t['bound_ms'] / t['ms']:.1f}% "
              f"of the bound, {t['hbm_gb_per_s']:.1f} GB/s; CUDA events {t['call_ms']:.6f} ms a launch back to "
              f"back; plain {t['plain_ms']:.6f} ms ({card})")
        out[cam] = t
        torch.cuda.empty_cache()
    return out


def timed_staging(device):
    """A StagingPool that records, for each upload, its bytes, the host
    seconds of its ``stage`` (the wait for its slot and the copy into
    pinned memory) and the CUDA events around its copy on the side
    stream."""
    from hulc_tpu_torch.data.loader import StagingPool

    class TimedStaging(StagingPool):
        def __init__(self, device):
            super().__init__(device)
            self.nbytes, self.stage_s, self.copy_events = [], [], []

        def stage(self, batch):
            t0 = time.perf_counter()
            slot, fields = super().stage(batch)
            self.stage_s.append(time.perf_counter() - t0)
            self.nbytes.append(sum(b.numel() * b.element_size() for f in fields.values() for b in f if b is not None))
            return slot, fields

        def copy(self, staged):
            start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(self.stream)
            out = super().copy(staged)
            done.record(self.stream)
            self.copy_events.append((start, done))
            return out

    return TimedStaging(device)


def check_upload(trainer, host_batches, label="training loop"):
    """DeviceLoader through the trainer's staging pool, with ``host_batches``
    (at least 3) uploaded back to back and no host wait, all queued behind
    UPLOAD_SPIN_S of device spin on the copy stream: each slot is staged
    again while the copy out of it is still queued. Every field of every
    uploaded batch, read on the consumer's stream, must equal its host
    batch byte for byte."""
    from hulc_tpu_torch.data.loader import DeviceLoader

    pool = trainer.staging
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    end.synchronize()
    with torch.cuda.stream(pool.stream):
        torch.cuda._sleep(int(1e6 / (start.elapsed_time(end) / 1e3) * UPLOAD_SPIN_S))
    got = list(DeviceLoader(host_batches, trainer.device, pool))
    fields = 0
    for i, (dev, host) in enumerate(zip(got, host_batches)):
        for scope, mod in host.items():
            for name, h, d in zip(mod._fields, mod, dev[scope]):
                if (h is None) != (d is None):
                    fail(f"upload {i}: {scope}.{name} is {'missing' if d is None else 'not None'} on the device")
                if h is None:
                    continue
                if not torch.equal(d, torch.from_numpy(np.ascontiguousarray(h)).to(d.device)):
                    fail(f"upload {i} of {len(host_batches)} back to back: {scope}.{name} on the device differs "
                         f"from its host batch")
                fields += 1
    print(f"[{label}] {len(host_batches)} batches uploaded back to back through the two staging slots behind "
          f"{1e3 * UPLOAD_SPIN_S:.0f} ms of spin on the copy stream: all {fields} fields byte-equal to their host "
          f"batches on the device")
    return {"batches": len(host_batches), "fields": fields}


def time_loop(trainer, loader, label, step_seq_per_s, card):
    """``timed_epoch`` over ``loader``, and the medians of its uploads."""
    trainer.staging = up = timed_staging(trainer.device)
    seq_s, step_ms, n = timed_epoch(trainer, loader, trainer.cfg.loss.kl_beta)
    copy_ms = [a.elapsed_time(b) for a, b in up.copy_events]
    run = {"seq_per_s": seq_s, "step_host_ms": step_ms, "batch_mb": statistics.median(up.nbytes) / 1e6,
           "stage_host_ms": 1e3 * statistics.median(up.stage_s), "copy_device_ms": statistics.median(copy_ms)}
    print(f"[training loop] {n} batches of random windows ({label}) through the upload and train_step: "
          f"{seq_s:.2f} seq/s after the first step, host clock between step calls "
          f"{[round(t, 2) for t in step_ms]} ms (no host wait); the device-resident train step (phase 8): "
          f"{step_seq_per_s:.2f} seq/s ({card})")
    print(f"[training loop] upload of a {run['batch_mb']:.1f} MB batch ({label}): into pinned memory "
          f"{run['stage_host_ms']:.4f} ms (host clock), host-to-device copy on the side stream "
          f"{run['copy_device_ms']:.4f} ms (CUDA events, {run['batch_mb'] / run['copy_device_ms']:.1f} GB/s), "
          f"medians of {len(copy_ms)} ({card})")
    return run


def check_shm_cache(cfg, root, seed, ram_train, trainer, step_seq_per_s, card):
    """The training split in a shared-memory arena (``cache="shm"``: the
    port's g++ build of its C++ cache) against the ram cache: the same
    fused batches byte for byte from one seed, the host ms per fused batch
    with SHM_GATHER_THREADS gather threads, and the loop's rate over it.
    The arena is unlinked after."""
    from hulc_tpu_torch.data.loader import make_loaders
    from hulc_tpu_torch.data.shm_store import ShmEpisodeCache

    store = ram_train.loaders["vis"].store
    frame = store.get_window(store.episode_ranges[0][0], 1)
    need = store.num_frames * sum(v.nbytes for v in frame.values())
    free = shutil.disk_usage("/dev/shm").free
    if not free > 1.1 * need:
        fail(f"/dev/shm has {free} bytes free; the training split's arena needs {need}")
    kwargs = dict(batch_size=FIT_BATCH, fuse=True, seed=seed + 5)
    ram = make_loaders(cfg, root, **kwargs)
    shm = make_loaders(cfg, root, cache="shm", gather_threads=SHM_GATHER_THREADS, **kwargs)
    arena = shm.loaders["vis"].store.shm
    try:
        for _ in range(2):
            got, want = shm._make()["fused"], ram._make()["fused"]
            for name, a, b in zip(got._fields, got, want):
                if (a is None) != (b is None) or (a is not None and not np.array_equal(a, b)):
                    fail(f"the shm cache's fused batch differs from the ram cache's in {name}")
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            shm._make()
            times.append((time.perf_counter() - t0) * 1e3)
        out = {"arena_mb": need / 1e6, "dev_shm_free_mb": free / 1e6, "host_ms": statistics.median(times[1:])}
        print(f"[training loop] shm cache ({arena.name}, {need / 1e6:.1f} MB of {free / 1e6:.1f} MB free in "
              f"/dev/shm): the ram cache's fused batches byte for byte; {out['host_ms']:.4f} ms per fused batch "
              f"with {SHM_GATHER_THREADS} gather threads (median of 3 after one), one assembly worker")
        out["loop"] = time_loop(trainer, long_epoch(shm.loaders, LOOP_BATCHES, 1),
                                f"shm cache, 1 worker, {SHM_GATHER_THREADS} gather threads", step_seq_per_s, card)
    finally:
        arena.close()
        ShmEpisodeCache.unlink(arena.name)
    return out


def timed_epoch(trainer, loader, kl_beta):
    """One pass of ``loader`` through the DeviceLoader and train_step with
    no host wait between steps, timed from the first step's end (a sync) to
    the last's: (seq/s, host ms between step calls, batches)."""
    batches = iter(trainer._device_batches(loader))
    first = next(batches)
    trainer.train_step(first, kl_beta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks, seqs = [t0], 0
    for batch in batches:
        trainer.train_step(batch, kl_beta)
        marks.append(time.perf_counter())
        seqs += sum(b.actions.shape[0] for b in batch.values())
    torch.cuda.synchronize()
    return seqs / (time.perf_counter() - t0), (np.diff(marks) * 1e3).tolist(), len(marks)


def run_training_loop(cfg, seed, card, step_seq_per_s):
    """Phase 12: Trainer.fit on a full-width fixture dataset, validation and
    checkpoints, a resume, the val step against the plain path, B.1 at the
    window shape, and where the loop's time goes."""
    from torch.profiler import ProfilerActivity, profile

    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.data.fixtures import make_fixture_dataset
    from hulc_tpu_torch.data.loader import make_loaders
    from hulc_tpu_torch.evaluation.profile_policy import device_events, device_ms as events_ms, kind_of
    from hulc_tpu_torch.training import checkpoint as ckpt
    from hulc_tpu_torch.training.preprocess import batch_to_device
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    print(f"[training loop] host: os.cpu_count() = {os.cpu_count()}")
    report = {"cpu_count": os.cpu_count()}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        root = make_fixture_dataset(tmp / "data", num_episodes=FIT_EPISODES, episode_len=FIT_EPISODE_LEN,
                                    small=False, seed=seed)
        npz_mb = sum(p.stat().st_size for p in root.rglob("*.npz")) / 1e6
        report["fixture"] = {"npz_mb": npz_mb, "write_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        train = make_loaders(cfg, root, batch_size=FIT_BATCH, fuse=True, seed=seed)
        val = make_loaders(cfg, root, split="validation", batch_size=FIT_BATCH, deterministic=True)
        print(f"[training loop] fixture: {FIT_EPISODES} training episodes of {FIT_EPISODE_LEN} frames and "
              f"{FIT_EPISODES // 2} validation episodes at 200 / 84 px, {npz_mb:.1f} MB of npz written in "
              f"{report['fixture']['write_s']:.2f} s; loaders (ram cache) built in {time.perf_counter() - t0:.2f} s: "
              f"{len(train)} fused training batches an epoch, {len(val)} validation batches")

        # the host loader alone, on this thread: a fused batch, and its parts
        # (each modality's windows gathered, then fuse_batch's row stacking)
        parts = {"fused_batch": train._make}
        for scope, loader in train.loaders.items():
            parts[f"{scope}_batch"] = loader.next_batch
        mods = {scope: loader.next_batch() for scope, loader in train.loaders.items()}
        parts["fuse_batch"] = lambda: type(train).fuse_batch(mods)
        host = {}
        for name, fn in parts.items():
            times = []
            for _ in range(4):
                t1 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t1) * 1e3)
            host[name] = statistics.median(times[1:])
        report["loader_host_ms"] = host
        print(f"[training loop] host loader, one thread, medians of 3 after one: "
              f"{host['fused_batch']:.4f} ms per fused batch of 2x{FIT_BATCH} windows of 32 frames "
              f"({sum(t.nbytes for m in mods.values() for t in m if t is not None) / 1e6:.1f} MB); of it "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in host.items() if k != "fused_batch"))

        run_dir = tmp / "run"
        tcfg = TrainerConfig(run_dir=str(run_dir), seed=seed, log_every=1, val_max_batches=FIT_VAL_BATCHES)
        trainer = Trainer(cfg, tcfg, "cuda")
        epoch_loader = FirstBatches(train, FIT_STEPS_PER_EPOCH)
        val_launches, val_calls = collections.Counter(), []
        count_validation(trainer, val_launches, val_calls)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        steps = trainer.fit(epoch_loader, val, max_epochs=FIT_EPOCHS)
        fit_s = time.perf_counter() - t0
        if steps != FIT_EPOCHS * FIT_STEPS_PER_EPOCH:
            fail(f"fit took {steps} steps, expected {FIT_EPOCHS * FIT_STEPS_PER_EPOCH}")
        # the resume: a new Trainer takes one more step from the last checkpoint
        resumed = Trainer(cfg, tcfg, "cuda")
        count_validation(resumed, val_launches, val_calls)
        steps = resumed.fit(epoch_loader, val, max_epochs=FIT_EPOCHS + 1, max_steps=1)
        torch.cuda.synchronize()
        loop_launches = launch_counts()
        if steps != FIT_EPOCHS * FIT_STEPS_PER_EPOCH + 1:
            fail(f"the resumed fit ended at step {steps}, expected {FIT_EPOCHS * FIT_STEPS_PER_EPOCH + 1}")
        print(f"[training loop] fit: {FIT_EPOCHS} epochs of {FIT_STEPS_PER_EPOCH} steps with validation "
              f"({FIT_VAL_BATCHES} batches an epoch) and checkpoints in {fit_s:.2f} s; resumed from "
              f"{ckpt.latest_checkpoint(run_dir).name} for 1 step; launches {loop_launches}; of them in validation "
              f"{dict(val_launches)}")

        # launches: every kernel of the train step, and validation's own
        train_launches = {s: loop_launches[s] - val_launches[s] for s in loop_launches}
        if not all(train_launches[s] > 0 for s in TRAIN_KERNELS):
            fail(f"a kernel of the training path was never launched in fit: {train_launches}")
        val_steps = FIT_VAL_BATCHES * len(val_calls)
        want = {s: 2 * n * val_steps for s, n in VAL_LAUNCHES_PER_MODALITY.items()}
        got = {s: n for s, n in val_launches.items() if n}
        if got != want:
            fail(f"validation launched {got}, expected {want} for {val_steps} val steps (B.1 at the window shape, "
                 f"B.3 over whole windows, B.3' forward without its backward, B.6 forward under no_grad)")

        # the JSONL: every line finite, train, val and epoch lines, the JAX val keys
        records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
        prefixes = collections.Counter(r["prefix"] for r in records)
        if set(prefixes) != {"train", "val", "epoch"}:
            fail(f"metrics.jsonl has the prefixes {dict(prefixes)}, expected train, val and epoch")
        for r in records:
            if not all(np.isfinite(v) for k, v in r.items() if k != "prefix"):
                fail(f"metrics.jsonl: a value is not finite: {r}")
        for r in records:
            if r["prefix"] == "val" and sorted(set(r) - {"step", "prefix"}) != VAL_KEYS:
                fail(f"the val line's keys {sorted(set(r) - {'step', 'prefix'})} are not JAX's {VAL_KEYS}")
        epochs = [r for r in records if r["prefix"] == "epoch"]
        report["fit"] = {"seconds": fit_s, "jsonl_lines": dict(prefixes), "epochs": epochs,
                         "val": [r for r in records if r["prefix"] == "val"][-1]}
        print(f"[training loop] metrics.jsonl: {dict(prefixes)} lines, all finite; the val keys are JAX's "
              f"{len(VAL_KEYS)}; epochs (epoch_time_s, seq_per_sec, kl_beta): "
              + "; ".join(f"{r['epoch_time_s']:.4f} s, {r['seq_per_sec']:.2f} seq/s, {r['kl_beta']}" for r in epochs))
        last = [r for r in records if r["prefix"] == "val"][-1]
        print("[training loop] last val: " + ", ".join(f"{k} {last[k]:.5f}" for k in VAL_KEYS))

        # the last checkpoint restores bit-equal
        latest = ckpt.latest_checkpoint(run_dir)
        probe = Trainer(cfg, TrainerConfig(run_dir=str(tmp / "probe"), seed=seed + 1), "cuda")
        probe.init_state(1)
        probe.restore(latest)
        for (k, a), (_, b) in zip(resumed.model.state_dict().items(), probe.model.state_dict().items()):
            if not torch.equal(a, b):
                fail(f"checkpoint {latest.name}: parameter {k} does not restore bit-equal")
        opt_a, opt_b = resumed.optimizer.checkpoint_state(), probe.optimizer.checkpoint_state()
        if opt_a["count"] != opt_b["count"] or not all(
            torch.equal(x, y) for key in ("exp_avg", "exp_avg_sq") for x, y in zip(opt_a[key], opt_b[key])
        ):
            fail(f"checkpoint {latest.name}: the Adam state does not restore bit-equal")
        if probe.step != resumed.step or not torch.equal(probe.generator.get_state(), resumed.generator.get_state()):
            fail(f"checkpoint {latest.name}: the step or the generator state does not restore")
        print(f"[training loop] {latest.name} restores the parameters, the Adam moments (count {opt_b['count']}), "
              f"the step and the generator bit-equal; checkpoints {[p.name for p in ckpt.all_checkpoints(run_dir)]}")
        del probe, trainer

        # the val step, through the kernels and against the plain path
        raw = next(iter(resumed._device_batches(val)))
        if not all(a is b for scope in raw for a, b in zip(raw[scope], batch_to_device(raw, "cuda")[scope])):
            fail("batch_to_device copied a batch that DeviceLoader had already uploaded")
        resumed.model.eval()
        with torch.no_grad():
            val_ms = host_ms(lambda: (resumed.val_step(raw), torch.cuda.synchronize()), 5)
        resumed.model.train()
        report["val_step_ms"] = val_ms
        print(f"[training loop] val step ({{vis, lang}} x {FIT_BATCH} windows of 32 frames, eval preprocess and "
              f"val_metrics): {val_ms:.4f} ms, host clock to a sync, median of 5 after 5 ({card})")
        report["plain_path"] = compare_val_plain(cfg, resumed, seed, raw)
        report["window_preprocess"] = check_window_preprocess(raw, card)
        del raw
        report["upload_check"] = check_upload(resumed, [train._make() for _ in range(UPLOAD_CHECK_BATCHES)])
        torch.cuda.empty_cache()

        # the loop's rate with the upload, beside the device-resident step:
        # long epochs of random windows, with one and with more assembly
        # workers, then over the shm cache
        report["loop"] = {"device_resident_seq_per_s": step_seq_per_s, "batches": LOOP_BATCHES}
        for workers in LOOP_WORKERS:
            report["loop"][f"ram_workers_{workers}"] = time_loop(
                resumed, long_epoch(train.loaders, LOOP_BATCHES, workers),
                f"ram cache, {workers} assembly worker{'s' if workers > 1 else ''}", step_seq_per_s, card,
            )
        loader = long_epoch(train.loaders, LOOP_BATCHES, LOOP_WORKERS[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, _, n_prof = timed_epoch(resumed, loader, cfg.loss.kl_beta)
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = device_events(prof)
        busy = events_ms([e for e in events if kind_of(e.key) != "copies and fills"])
        copies = events_ms([e for e in events if kind_of(e.key) == "copies and fills"])
        report["loop"]["profiled"] = {"wall_ms": wall_ms, "batches": n_prof, "kernel_busy_ms": busy, "copy_ms": copies,
                                      "idle_share": 1.0 - busy / wall_ms}
        print(f"[training loop] under torch.profiler, {n_prof} batches ({LOOP_WORKERS[0]} worker): wall {wall_ms:.4f} ms, "
              f"kernels busy {busy:.4f} ms, copies and fills {copies:.4f} ms, device idle "
              f"{100 * (1.0 - busy / wall_ms):.2f}% of the wall ({card})")
        report["shm"] = check_shm_cache(cfg, root, seed, train, resumed, step_seq_per_s, card)
    return report, loop_launches, report["window_preprocess"]


# --------------------------------------------------------------------------
# phase 13: the serving export
# --------------------------------------------------------------------------

# modules a serving host must not load: the port's model code, and JAX
SERVE_BANNED = ("hulc_tpu_torch.models", "hulc_tpu_torch.evaluation", "hulc_tpu_torch.training",
                "hulc_tpu_torch.config", "hulc_tpu_torch.data", "jax", "hulc_tpu")
VISUAL_STEPS = 5  # the visual-goal episode after the reset
DEBUG_STEPS = 4  # the hulc_debug artifact exported on the CPU and served on the card
SERVE_CHILD_TIMEOUT = 600


def step_launches(step):
    """(``step()``'s result, {kernel symbol: launches it made})."""
    from hulc_tpu_torch import kernels

    before = [k.launches for k in kernels.ALL_KERNELS]
    out = step()
    return out, {k.symbol: k.launches - b for k, b in zip(kernels.ALL_KERNELS, before)}


def drive_episodes(policy, lang_obs, lang, visual_obs, goal_obs):
    """A language-goal episode over ``lang_obs``, ``reset()``, a visual-goal
    episode over ``visual_obs``: (actions, launches of each step)."""
    actions, launches = [], []
    for obs, goal in ((lang_obs, lang), (visual_obs, goal_obs)):
        policy.reset()
        for o in obs:
            a, n = step_launches(lambda: policy.step(o, goal))
            actions.append(a)
            launches.append(n)
    return np.stack(actions), launches


def drive_lockstep(policy, obs_steps, langs, freq):
    """Lockstep steps with staggered replans: (actions, launches of each step)."""
    state, actions, launches = policy.initial_state(), [], []
    for t, obs in enumerate(obs_steps):
        (a, state), n = step_launches(lambda: policy.step(obs, langs, state, replan_mask(t, len(langs), freq)))
        actions.append(a)
        launches.append(n)
    return np.stack(actions), launches


def obs_arrays(obs):
    """A list of env obs (or of lists of them, one per lane) as stacked arrays."""
    def stack(get):
        return np.stack([np.stack([get(x) for x in o]) if isinstance(o, list) else get(o) for o in obs])

    return {"static": stack(lambda o: o["rgb_obs"]["rgb_static"]), "gripper": stack(lambda o: o["rgb_obs"]["rgb_gripper"]),
            "robot": stack(lambda o: o["robot_obs"])}


def obs_list(arrays, prefix):
    """Inverse of ``obs_arrays`` for the arrays stored under ``prefix``."""
    static, gripper, robot = (arrays[f"{prefix}_{k}"] for k in ("static", "gripper", "robot"))

    def one(idx):
        return {"rgb_obs": {"rgb_static": static[idx], "rgb_gripper": gripper[idx]}, "robot_obs": robot[idx]}

    if static.ndim == 5:  # (steps, lanes, H, W, 3)
        return [[one((t, e)) for e in range(static.shape[1])] for t in range(static.shape[0])]
    return [one(t) for t in range(static.shape[0])]


def serve_child(work: pathlib.Path) -> int:
    """The served side of a serving export, in a fresh process that imports
    only the serving runtime: each artifact of ``inputs.json``'s
    ``artifacts`` (and ``debug``, where it was exported) driven over the
    observations the parent wrote, with each step's launches, and the
    served steps' host times; writes ``served.npz`` and ``served.json``
    into ``work``, keyed ``<artifact>_single`` / ``<artifact>_batched``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.serving import ServedBatchedPolicy, ServedPolicy

    spec = json.loads((work / "inputs.json").read_text())
    with np.load(work / "inputs.npz") as z:
        arrays = {k: z[k] for k in z.files}
    seed, freq = spec["seed"], spec["replan_freq"]
    kernels.build()
    kernels.library()
    goal = obs_list(arrays, "goal")[0]
    single_obs, batched_obs = obs_list(arrays, "single"), obs_list(arrays, "batched")
    out, report = {}, {"load_s": {}, "step_ms": {}}
    for art in spec["artifacts"]:
        t0 = time.perf_counter()
        single = ServedPolicy(work / art, seed=seed)
        batched = ServedBatchedPolicy(work / art, seed=seed)
        report["load_s"][art] = time.perf_counter() - t0
        out[f"{art}_single"], report[f"{art}_single"] = drive_episodes(
            single, single_obs, arrays["lang"], obs_list(arrays, "visual"), goal)
        out[f"{art}_batched"], report[f"{art}_batched"] = drive_lockstep(batched, batched_obs, arrays["langs"], freq)
        report["step_ms"][art] = policy_step_ms(single, batched, single_obs[0], arrays["lang"], batched_obs[0],
                                                arrays["langs"])
    if (work / "debug").exists():
        debug = ServedPolicy(work / "debug", seed=seed)
        out["debug"], report["debug"] = drive_episodes(debug, obs_list(arrays, "debug"), arrays["debug_lang"], [], None)
        report["debug_moved"] = debug.meta["device"] != str(debug.device)
    report["loaded"] = sorted(m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in SERVE_BANNED))
    np.savez(work / "served.npz", **out)
    (work / "served.json").write_text(json.dumps(report))
    return 0


def dispatch_us(cfg, gen):
    """Host microseconds per call of each serving op (``torch.ops.hulc.*``,
    through the dispatcher) and of the kernel function it calls, at one
    lane's shapes: the median of 5 runs of 1000 back-to-back calls ended by
    a sync (the host issues slower than these kernels run)."""
    from hulc_tpu_torch.ops import image_ops, logistic_mixture, recurrence, spatial_softmax
    from hulc_tpu_torch.ops.logistic_mixture import U_MIN, U_SPAN

    dev, pe, ad = "cuda", cfg.perceptual_encoder, cfg.action_decoder
    imgs = torch.randint(0, 256, (1, 1, pe.rgb_static.input_size, pe.rgb_static.input_size, 3), generator=gen,
                         device=dev, dtype=torch.uint8)
    conv_map = torch.randn((1, 64, 21, 21), generator=gen, device=dev)
    shape = (1, 1, ad.out_features - 1, ad.n_mixtures)
    mix = [torch.randn(shape, generator=gen, device=dev) for _ in range(3)] + [
        torch.rand(shape, generator=gen, device=dev), torch.rand(shape[:-1], generator=gen, device=dev),
        torch.randn((1, 1, 2), generator=gen, device=dev)]
    h = ad.hidden_size
    rnn = [torch.randn((1, 1, h), generator=gen, device=dev), torch.randn((1, h), generator=gen, device=dev),
           torch.randn((h, h), generator=gen, device=dev) / h**0.5, torch.randn(h, generator=gen, device=dev)]
    bounds, umap = (-1.0, 1.0), (U_MIN, U_SPAN)
    pairs = {
        "preprocess_rgb": (lambda: torch.ops.hulc.preprocess_rgb(imgs, 0.5, 0.5),
                           lambda: image_ops.preprocess_rgb_seq_kernel(imgs, 0.5, 0.5)),
        "spatial_softmax": (lambda: torch.ops.hulc.spatial_softmax(conv_map, None, 1.0),
                            lambda: spatial_softmax.spatial_softmax_fwd_kernel(conv_map, 1.0)),
        "sample_action": (lambda: torch.ops.hulc.sample_action(*mix, *bounds, *umap),
                          lambda: logistic_mixture.sample_action_kernel(*mix, bounds, umap)),
        "rnn_relu_fwd": (lambda: torch.ops.hulc.rnn_relu_fwd(*rnn), lambda: recurrence.rnn_relu_fwd_kernel(*rnn)),
    }

    def per_call_us(fn):
        for _ in range(50):
            fn()
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(runs)

    return {name: {"op_us": per_call_us(op), "direct_us": per_call_us(direct)} for name, (op, direct) in pairs.items()}


def run_serving_export(models, seed, lanes, single_obs, lang, batched_obs, langs, card, with_debug=True):
    """Phase 13: export each full-width policy of ``models`` ({artifact
    name: (cfg, model, serving kernels)}, at ``lanes`` lanes, the cameras
    of one config) and, with ``with_debug``, a ``hulc_debug`` one exported
    on the CPU; serve them all in one fresh process that loads no model
    code; hold each served step's actions bit-equal to the live policy's on
    the same observations and seed, and its launches equal; with
    ``with_debug`` also each op's dispatcher cost. An artifact's serving
    kernels: the kernels its served path must launch, and the only ones it
    may (the decoder cell's recurrence among them, or none). Returns
    (summary by artifact, {kernel symbol: served launches})."""
    from hulc_tpu_torch.config import get_config
    from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
    from hulc_tpu_torch.evaluation.policy import HulcPolicy
    from hulc_tpu_torch.models import make_model
    from hulc_tpu_torch.serving import export_policy

    rng = np.random.default_rng(seed + 13)
    cfg0 = next(iter(models.values()))[0]
    visual_obs, goal_obs = make_obs(rng, cfg0, VISUAL_STEPS), make_obs(rng, cfg0, 1)
    dbg_cfg = get_config("hulc_debug")
    dbg_obs = make_obs(rng, dbg_cfg, DEBUG_STEPS)
    dbg_lang = rng.normal(size=dbg_cfg.lang_dim).astype(np.float32)
    summary, live = {"card": card}, {}
    with tempfile.TemporaryDirectory(prefix="hulc_serving_") as tmp:
        work = pathlib.Path(tmp)
        for name, (cfg, model, _) in models.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            export_policy(cfg, model, work / name, lanes=lanes)
            export_s = time.perf_counter() - t0
            art_bytes = sum(f.stat().st_size for f in (work / name).iterdir())
            meta = json.loads((work / name / "meta.json").read_text())
            print(f"[serving export] {name}: the full-width policy at {lanes} lanes exported in {export_s:.3f} s on "
                  f"the card, {art_bytes} bytes ({sorted(f.name for f in (work / name).iterdir())}; noise "
                  f"{meta['noise']['order']}) ({card})")
            live[f"{name}_single"] = drive_episodes(HulcPolicy(cfg, model, seed=seed), single_obs, lang, visual_obs,
                                                    goal_obs[0])
            live[f"{name}_batched"] = drive_lockstep(BatchedHulcPolicy(cfg, model, lanes, seed=seed), batched_obs,
                                                     langs, cfg.replan_freq)
            live_ms = policy_step_ms(HulcPolicy(cfg, model, seed=seed), BatchedHulcPolicy(cfg, model, lanes, seed=seed),
                                     single_obs[0], lang, batched_obs[0], langs)
            summary[name] = {"export_s": export_s, "artifact_bytes": art_bytes, "noise": meta["noise"]["order"],
                             "step_ms": {"live": {"1": live_ms[0], str(lanes): live_ms[1]}}}
        if with_debug:
            dbg_model = make_model(dbg_cfg, "cpu", seed=seed)
            export_policy(dbg_cfg, dbg_model, work / "debug", device="cpu")
            summary["debug_artifact_bytes"] = sum(f.stat().st_size for f in (work / "debug").iterdir())
            print(f"[serving export] hulc_debug exported on the CPU, {summary['debug_artifact_bytes']} bytes")
            live["debug"] = drive_episodes(HulcPolicy(dbg_cfg, dbg_model.to("cuda"), seed=seed), dbg_obs, dbg_lang,
                                           [], None)

        arrays = {"lang": lang, "langs": langs, "debug_lang": dbg_lang}
        for key, obs in (("single", single_obs), ("visual", visual_obs), ("goal", goal_obs), ("batched", batched_obs),
                         ("debug", dbg_obs)):
            arrays.update({f"{key}_{k}": v for k, v in obs_arrays(obs).items()})
        np.savez(work / "inputs.npz", **arrays)
        (work / "inputs.json").write_text(json.dumps({"seed": seed, "replan_freq": cfg0.replan_freq,
                                                      "artifacts": list(models)}))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-child", str(work)],
                              capture_output=True, text=True, timeout=SERVE_CHILD_TIMEOUT)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"the serving process failed ({proc.returncode}):\n{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        report = json.loads((work / "served.json").read_text())
        with np.load(work / "served.npz") as z:
            served = {k: z[k] for k in z.files}

    if report["loaded"]:
        fail(f"the serving process loaded model code or JAX: {report['loaded']}")
    if with_debug and not report["debug_moved"]:
        fail("the hulc_debug artifact exported on the CPU was not moved to the card")
    summary.update(load_s=report["load_s"], child_s=child_s)
    served_launches = collections.Counter()
    for key, (live_actions, live_launches) in live.items():
        name, kind = ("debug", "single") if key == "debug" else key.rsplit("_", 1)
        serving_kernels = models[name][2] if name in models else SERVING_KERNELS
        got = served[key]
        if got.shape != live_actions.shape or not np.array_equal(got, live_actions):
            fail(f"served {key}: actions not bit-equal to the live policy's (max abs err "
                 f"{float(np.abs(got - live_actions).max()) if got.shape == live_actions.shape else 'shape'})")
        for t, (s_n, l_n) in enumerate(zip(report[key], live_launches)):
            if s_n != l_n:
                fail(f"served {key} step {t}: launches {s_n}, the live step's {l_n}")
        totals = collections.Counter()
        for n in report[key]:
            totals.update(n)
        if not all(totals[k] > 0 for k in serving_kernels):
            fail(f"served {key}: a serving kernel was never launched: {dict(totals)}")
        if any(v for k, v in totals.items() if k not in serving_kernels):
            fail(f"served {key}: a kernel off the serving path was launched: {dict(totals)}")
        if key != "debug":
            served_launches.update(totals)
        summary.setdefault(name, {})[kind] = {"steps": len(got), "bit_equal": True,
                                              "launches": {k: totals[k] for k in serving_kernels}}
        print(f"[serving export] served {key}: {len(got)} steps bit-equal to the live policy; every step's launches "
              f"equal the live step's: {summary[name][kind]['launches']}")
    for name in models:
        served_ms = report["step_ms"][name]
        summary[name]["step_ms"]["served"] = {"1": served_ms[0], str(lanes): served_ms[1]}
        live_ms = summary[name]["step_ms"]["live"]
        print(f"[serving export] {name} step host ms (median), served / live: 1 lane {served_ms[0]:.4f} / "
              f"{live_ms['1']:.4f}, {lanes} lanes {served_ms[1]:.4f} / {live_ms[str(lanes)]:.4f}; loaded in "
              f"{report['load_s'][name]:.3f} s ({card})")
    if with_debug:
        summary["dispatch_us"] = dispatch_us(cfg0, torch.Generator(device="cuda").manual_seed(seed))
        print("[serving export] host us per call through the hulc:: op / of the kernel function alone, one lane: "
              + ", ".join(f"{k} {v['op_us']:.2f} / {v['direct_us']:.2f}" for k, v in summary["dispatch_us"].items())
              + f" ({card})")
    print(f"[serving export] {', '.join(models)} served by one process in {child_s:.3f} s, which loaded no model "
          f"code ({card})")
    return summary, served_launches


# --------------------------------------------------------------------------
# phase 14: mcil at full width
# --------------------------------------------------------------------------

MCIL_STEPS_FIRST, MCIL_STEPS_AFTER_RESET = 32, 3  # single lane: replans at 0 and 30, reset, replan at 0
MCIL_EVAL_CHAINS, MCIL_EVAL_EP_LEN = 64, 30  # a short evaluate_policy_batched pass at --lanes lanes
# the kernels the mcil path must launch: B.1, B.2, B.3, B.3', B.6, B.8, B.9,
# and the train step's B.1', B.2', B.5 and B.7
MCIL_KERNELS = (
    "hulc_preprocess_rgb", "hulc_spatial_softmax", "hulc_logistic_mixture_sample", "hulc_mixture_nll_fwd",
    "hulc_mixture_nll_bwd", "hulc_rnn_relu_fwd", "hulc_rnn_relu_bwd", "hulc_rnn_tanh_fwd", "hulc_rnn_tanh_bwd",
    "hulc_birnn_tanh_fwd", "hulc_birnn_tanh_bwd", "hulc_preprocess_rgb_shift", "hulc_spatial_softmax_bwd",
    "hulc_adam_lowp", "hulc_grad_norm_finish",
)
MCIL_NOT_REACHED = ("hulc_plan_st_kl_fwd", "hulc_plan_st_kl_bwd")  # B.4: the continuous plan runs eager


def birnn_params(net, k):
    """Layer k of a ScanBiRNN: ({name: forward chain's}, {name: reverse chain's})."""
    names = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
    return ({n: getattr(net, f"{n}_l{k}").detach() for n in names},
            {n: getattr(net, f"{n}_l{k}_reverse").detach() for n in names})


def check_tanh_chain(xp, h0, w, bias, dy, dcarry, where):
    """B.8 on one chain: the forward kernel's y and final state against the
    plain loop, the dh-chain kernel against the plain dh chain on the same
    inputs, and the autograd Function's four gradients against the closed
    form and against autograd through the loop, each within REC_REL
    (relative L2). Returns (largest absolute error of y, of the gradients)."""
    from hulc_tpu_torch.ops.recurrence import (
        dh_chain_tanh_plain, recurrence_weight_grads, rnn_tanh, rnn_tanh_bwd, rnn_tanh_fwd, rnn_tanh_fwd_plain,
    )

    shape = tuple(xp.shape)
    got, got_last = rnn_tanh_fwd(xp, h0, w, bias)
    want = rnn_tanh_fwd_plain(xp, h0, w, bias)
    if not (rel_l2(got, want) <= REC_REL and torch.equal(got_last, got[:, -1])):
        fail(f"tanh recurrence forward kernel at {where} {shape}: relative L2 {rel_l2(got, want)}, final state "
             f"equal to y[:, -1]: {torch.equal(got_last, got[:, -1])}")
    errs = {}
    for name, g, r in zip(("dpre", "dh0"), rnn_tanh_bwd(dy, want, dcarry, w), dh_chain_tanh_plain(dy, want, dcarry, w)):
        errs[f"{name} kernel vs plain"] = rel_l2(g, r)
    leaves = [t.clone().requires_grad_() for t in (xp, h0, w, bias)]
    k_grads = torch.autograd.grad(rnn_tanh(*leaves), leaves, [dy, dcarry])
    dpre, dh0 = dh_chain_tanh_plain(dy, want, dcarry, w)
    closed = (dpre, dh0, *recurrence_weight_grads(dpre, h0, want))
    leaves = [t.clone().requires_grad_() for t in (xp, h0, w, bias)]
    y = rnn_tanh_fwd_plain(*leaves)
    auto = torch.autograd.grad([y, y[:, -1]], leaves, [dy, dcarry])
    for ref, wants in (("closed form", closed), ("autograd", auto)):
        for n, g, r in zip(("dxp", "dh0", "dW_hh", "db_hh"), k_grads, wants):
            errs[f"{n} vs {ref}"] = rel_l2(g, r)
    if not max(errs.values()) <= REC_REL:
        fail(f"tanh recurrence backward at {where} {shape}: relative L2 {errs}")
    bwd_err = max(max_abs(g, r) for g, r in zip(k_grads, auto))
    print(f"[mcil] B.8 at {where} {shape}: y relative L2 {rel_l2(got, want):.3g}, max abs err "
          f"{max_abs(got, want):.3g}; dh chain and gradients relative L2 up to {max(errs.values()):.3g}, max abs err "
          f"{bwd_err:.3g}")
    return max_abs(got, want), bwd_err


def check_birnn_layer(xp_f, xp_b, h0s, fwd, rev, dy, where):
    """B.9 on one bidirectional layer: the forward (two launches into one
    (B, S, 2H) output) against JAX's flip-and-concatenate definition, the
    backward kernels (each chain's dh chain over its half) against the
    flipped plain dh chains on the same inputs, and the autograd Function's
    seven gradients against autograd through the definition, each within
    REC_REL (relative L2). Returns (plain y, largest absolute error of y,
    of the gradients)."""
    from hulc_tpu_torch.ops.recurrence import birnn_layer, birnn_layer_bwd, birnn_layer_bwd_plain, birnn_layer_fwd
    from hulc_tpu_torch.ops.recurrence import birnn_layer_plain

    weights = (fwd["weight_hh"], rev["weight_hh"], fwd["bias_hh"], rev["bias_hh"])
    shape = tuple(xp_f.shape)
    got = birnn_layer_fwd(xp_f, xp_b, h0s, *weights)
    want = birnn_layer_plain(xp_f, xp_b, h0s, *weights)
    if not rel_l2(got, want) <= REC_REL:
        fail(f"bidirectional layer forward at {where} {shape}: relative L2 {rel_l2(got, want)}")
    errs = {}
    kern = birnn_layer_bwd(dy, want, weights[0], weights[1])
    for name, g, r in zip(("dpre_f", "dpre_b", "dh0s"), kern, birnn_layer_bwd_plain(dy, want, weights[0], weights[1])):
        errs[f"{name} kernel vs plain"] = rel_l2(g, r)
    inputs = (xp_f, xp_b, h0s, *weights)
    leaves = [t.clone().requires_grad_() for t in inputs]
    k_grads = torch.autograd.grad(birnn_layer(*leaves), leaves, dy)
    leaves = [t.clone().requires_grad_() for t in inputs]
    auto = torch.autograd.grad(birnn_layer_plain(*leaves), leaves, dy)
    for n, g, r in zip(("dxp_f", "dxp_b", "dh0s", "dW_hh_f", "dW_hh_b", "db_hh_f", "db_hh_b"), k_grads, auto):
        errs[f"{n} vs autograd"] = rel_l2(g, r)
    if not max(errs.values()) <= REC_REL:
        fail(f"bidirectional layer backward at {where} {shape}: relative L2 {errs}")
    bwd_err = max(max_abs(g, r) for g, r in zip(k_grads, auto))
    print(f"[mcil] B.9 at {where} {shape} -> {tuple(want.shape)}: y relative L2 {rel_l2(got, want):.3g}, max abs err "
          f"{max_abs(got, want):.3g}; backward kernels and gradients relative L2 up to {max(errs.values()):.3g}, max "
          f"abs err {bwd_err:.3g}")
    return want, max_abs(got, want), bwd_err


def check_birnn(model, seed):
    """B.8 and B.9 against their plain versions: at the train step's (64, 32,
    2048) with the model's plan-recognition weights, B.8 on each layer's
    forward-chain W_hh with a nonzero carry and a carry gradient, B.9
    through both layers (layer 0 from 128 input features, layer 1 from
    layer 0's plain 4096), dense cotangents; then B.9 at odd shapes: a
    cluster of 4 (3, 5, 37), the one-step launch into a 2H-wide output
    (3, 1, 37) and two row tiles (96, 3, 64). Returns the largest errors,
    by kernel row."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed + 37)
    net = model.plan_recognition.birnn_model
    h = net.hidden_size
    b, s = DECODER_ROWS, DECODER_SEQ
    errs = {"rnn_tanh_fwd": 0.0, "rnn_tanh_bwd": 0.0, "birnn_tanh_fwd": 0.0, "birnn_tanh_bwd": 0.0}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    for k in range(net.num_layers):
        fwd, _ = birnn_params(net, k)
        e = check_tanh_chain(randn(b, s, h), torch.tanh(randn(b, h)), fwd["weight_hh"], fwd["bias_hh"],
                             randn(b, s, h), randn(b, h), f"the train step, layer {k}'s W_hh")
        errs["rnn_tanh_fwd"], errs["rnn_tanh_bwd"] = max(errs["rnn_tanh_fwd"], e[0]), max(errs["rnn_tanh_bwd"], e[1])

    def layer_case(x, fwd, rev, where):
        with torch.no_grad():
            xp_f = F.linear(x, fwd["weight_ih"], fwd["bias_ih"])
            xp_b = F.linear(x, rev["weight_ih"], rev["bias_ih"])
        hid = fwd["weight_hh"].shape[0]
        y, *e = check_birnn_layer(xp_f, xp_b, torch.zeros(2, x.shape[0], hid, device="cuda"), fwd, rev,
                                  randn(x.shape[0], x.shape[1], 2 * hid), where)
        errs["birnn_tanh_fwd"], errs["birnn_tanh_bwd"] = max(errs["birnn_tanh_fwd"], e[0]), max(errs["birnn_tanh_bwd"], e[1])
        return y

    x = randn(b, s, net.weight_ih_l0.shape[1])
    for k in range(net.num_layers):
        x = layer_case(x, *birnn_params(net, k), f"the train step, layer {k}")

    def uniform(hid, *shape):
        return (2.0 * torch.rand(shape, generator=gen, device="cuda") - 1.0) / hid**0.5

    for bb, ss, hid, where in ((3, 5, 37, "a cluster of 4"), (3, 1, 37, "one step (the GEMV launch)"),
                               (96, 3, 64, "two row tiles")):
        chains = [{"weight_ih": uniform(hid, hid, 11), "weight_hh": uniform(hid, hid, hid), "bias_ih": uniform(hid, hid),
                   "bias_hh": uniform(hid, hid)} for _ in range(2)]
        layer_case(randn(bb, ss, 11), *chains, where)
    return errs


def time_birnn(model, seed):
    """Device ms of B.8 and B.9 at the train step's (64, 32, 2048) against
    their plain versions and cuDNN's tanh RNN (W_ih = I, b_ih = 0, so it
    computes the same function of xp; bidirectional for B.9, both chains
    fed the same xp), by CUDA events in turns plain, kernel, kernel,
    plain, with the bound: 2 B S H^2 fp32 FLOP per chain at 67 TFLOP/s.
    The port never calls cuDNN."""
    from hulc_tpu_torch.evaluation.kernel_times import event_ms
    from hulc_tpu_torch.ops.recurrence import (
        birnn_layer_bwd, birnn_layer_bwd_plain, birnn_layer_fwd, birnn_layer_plain, dh_chain_tanh_plain, rnn_tanh_bwd,
        rnn_tanh_fwd, rnn_tanh_fwd_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 41)
    net = model.plan_recognition.birnn_model
    h, b, s = net.hidden_size, DECODER_ROWS, DECODER_SEQ
    fwd, rev = birnn_params(net, 1)
    w, bias, w_b, bias_b = fwd["weight_hh"], fwd["bias_hh"], rev["weight_hh"], rev["bias_hh"]
    xp = torch.randn((b, s, h), generator=gen, device="cuda")
    dy, dy2 = torch.randn((b, s, h), generator=gen, device="cuda"), torch.randn((b, s, 2 * h), generator=gen,
                                                                                    device="cuda")
    h0, h0s = torch.zeros((b, h), device="cuda"), torch.zeros((2, b, h), device="cuda")
    cudnn = {d: torch.nn.RNN(h, h, nonlinearity="tanh", batch_first=True, bidirectional=d, device="cuda")
             for d in (False, True)}
    with torch.no_grad():
        for d, rnn in cudnn.items():
            for sfx, (ww, bb) in (("", (w, bias)), ("_reverse", (w_b, bias_b)))[:1 + d]:
                getattr(rnn, f"weight_ih_l0{sfx}").copy_(torch.eye(h, device="cuda"))
                getattr(rnn, f"bias_ih_l0{sfx}").zero_()
                getattr(rnn, f"weight_hh_l0{sfx}").copy_(ww)
                getattr(rnn, f"bias_hh_l0{sfx}").copy_(bb)
        y = rnn_tanh_fwd_plain(xp, h0, w, bias)
        y2 = birnn_layer_plain(xp, xp, h0s, w, w_b, bias, bias_b)
        for d, want in ((False, y), (True, y2)):
            lib = cudnn[d](xp, torch.zeros((1 + d, b, h), device="cuda"))[0]
            if rel_l2(lib, want) > 1e-4:
                fail(f"cuDNN's tanh RNN (bidirectional {d}) does not compute the recurrence: relative L2 "
                     f"{rel_l2(lib, want)}")
    lib_in = {d: (xp.clone().requires_grad_(), torch.zeros((1 + d, b, h), device="cuda", requires_grad=True))
              for d in (False, True)}
    lib_out = {d: cudnn[d](*lib_in[d])[0] for d in (False, True)}

    def lib_bwd(d, cot):
        return lambda: torch.autograd.grad(lib_out[d], [*lib_in[d], *cudnn[d].parameters()], cot, retain_graph=True)

    bsh, flops = b * s * h, 2 * b * s * h * h
    cases = {
        # xp, y: B S H each; W, b_hh, h0
        "rnn_tanh_fwd": (lambda: rnn_tanh_fwd(xp, h0, w, bias), lambda: rnn_tanh_fwd_plain(xp, h0, w, bias),
                         bound(4 * (2 * bsh + h * h + h + b * h), flops), lambda: cudnn[False](xp, h0[None])),
        # dy, y in, dpre out; W; dh0 out
        "rnn_tanh_bwd": (lambda: rnn_tanh_bwd(dy, y, None, w), lambda: dh_chain_tanh_plain(dy, y, None, w),
                         bound(4 * (3 * bsh + h * h + b * h), flops), lib_bwd(False, dy)),
        # both chains: xp_f, xp_b in, y (B, S, 2H) out, two W, b_hh, h0
        "birnn_tanh_fwd": (lambda: birnn_layer_fwd(xp, xp, h0s, w, w_b, bias, bias_b),
                           lambda: birnn_layer_plain(xp, xp, h0s, w, w_b, bias, bias_b),
                           bound(4 * (4 * bsh + 2 * (h * h + h + b * h)), 2 * flops),
                           lambda: cudnn[True](xp, h0s)),
        # dy, y (B, S, 2H) in, two dpre (B, S, H) out, two W, two dh0 out
        "birnn_tanh_bwd": (lambda: birnn_layer_bwd(dy2, y2, w, w_b), lambda: birnn_layer_bwd_plain(dy2, y2, w, w_b),
                           bound(4 * (6 * bsh + 2 * (h * h + b * h)), 2 * flops), lib_bwd(True, dy2)),
    }
    out = {}
    for name, (kernel_fn, plain_fn, (bound_ms, bound_by), library_fn) in cases.items():
        ms_ = [event_ms(plain_fn, 10), event_ms(kernel_fn), event_ms(kernel_fn), event_ms(plain_fn, 10)]
        out[name] = {
            "ms": min(ms_[1], ms_[2]), "plain_ms": min(ms_[0], ms_[3]), "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": event_ms(library_fn, 10), "call_ms": call_ms(kernel_fn, 20),
            "plain_call_ms": call_ms(plain_fn, 20), "timed_by": "CUDA events", "shape": [b, s, h],
        }
    out["rnn_tanh_fwd"]["plan"] = dataclasses.asdict(recurrence_plan_for(b, s, h, False))
    out["rnn_tanh_bwd"]["plan"] = dataclasses.asdict(recurrence_plan_for(b, s, h, True))
    return out


def split_fused(batch):
    """A loader-fused {"fused": 2B} batch as {"vis": B, "lang": B}."""
    from hulc_tpu_torch.models.hulc import ModalityBatch

    fused = batch["fused"]
    b = fused.actions.shape[0] // 2
    lang_only = ModalityBatch.LANG_ONLY_FIELDS

    def half(sl, lang):
        return ModalityBatch(**{f: (getattr(fused, f) if lang else None) if f in lang_only
                                else None if getattr(fused, f) is None else getattr(fused, f)[sl]
                                for f in ModalityBatch._fields})

    return {"vis": half(slice(0, b), False), "lang": half(slice(b, None), True)}


def drive_mcil_single(cfg, model, obs, lang, seed):
    """HulcPolicy over ``obs``: MCIL_STEPS_FIRST steps (replans at 0 and
    replan_freq), ``reset()``, the rest; (actions, pre-step states,
    post-step plans)."""
    from hulc_tpu_torch.evaluation.policy import HulcPolicy

    policy = HulcPolicy(cfg, model, seed=seed)
    actions, states, plans = [], [], []
    for t, o in enumerate(obs):
        if t in (0, MCIL_STEPS_FIRST):
            policy.reset()
        states.append(policy._state)
        actions.append(policy.step(o, lang))
        plans.append(policy._state.plan[0].cpu().numpy())
    return np.stack(actions), states, np.stack(plans)


def plain_mcil_single(cfg, plain_model, obs, lang, seed, kern_states):
    """The single-lane steps through the plain model from the kernel path's
    states, the reset at the same step; (actions, post-step plans)."""
    from hulc_tpu_torch.evaluation.policy import HulcPolicy

    policy = HulcPolicy(cfg, plain_model, seed=seed)
    actions, plans = [], []
    for t, o in enumerate(obs):
        if t in (0, MCIL_STEPS_FIRST):
            policy.reset()
        policy._state = kern_states[t]
        actions.append(policy.step(o, lang))
        plans.append(policy._state.plan[0].cpu().numpy())
    return np.stack(actions), np.stack(plans)


def run_mcil(seed, lanes, train_steps, card):
    """Phase 14: the ``mcil`` model at full width. Returns (summary, {kernel
    symbol: launches on the mcil path}, {row: max abs err}, {row: timing})."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.config import get_config
    from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
    from hulc_tpu_torch.evaluation.eval_split import run_batched
    from hulc_tpu_torch.models import make_model
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ, synthetic_fused_batch
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    cfg = get_config("mcil")
    model = make_model(cfg, "cuda", seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[mcil] mcil preset, {n_params} parameters, random init from seed {seed}: a {cfg.plan_recognition.birnn_num_layers}"
          f"-layer bidirectional {cfg.plan_recognition.birnn_cell} RNN (H = {cfg.plan_recognition.birnn_hidden_size}), "
          f"a {cfg.distribution.plan_features}-d Normal plan, {cfg.action_decoder.num_classes} classes, no gripper head")

    # 2. B.8 and B.9 against their plain versions, and their times; B.3' at
    # the decoder's shapes here: 7 sampled dimensions, 256 classes, no gripper
    errs = check_birnn(model, seed)
    ad = cfg.action_decoder
    gen = torch.Generator(device="cuda").manual_seed(seed + 47)
    mixture, actions = mixture_inputs((DECODER_ROWS, DECODER_SEQ), ad.out_features, ad.n_mixtures, False, gen)
    consts = (ad.act_min_bound, ad.act_max_bound, ad.num_classes, ad.log_scale_min, ad.gripper_alpha)
    errs["mixture_nll_fwd"], errs["mixture_nll_bwd"] = check_mixture(
        mixture, actions, consts, torch.randn((DECODER_ROWS, DECODER_SEQ), generator=gen, device="cuda"),
        f"mcil's shape, {ad.num_classes} classes")
    timing = time_birnn(model, seed)
    for name, t in timing.items():
        print(f"[mcil] {name} at {tuple(t['shape'])}: kernel {t['ms']:.6f} ms, plain {t['plain_ms']:.6f} ms, cuDNN "
              f"{t['library_ms']:.6f} ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']}), {100 * t['bound_ms'] / t['ms']:.1f}% "
              f"of the bound; per call with the host's launch cost {t['call_ms']:.5f} ms (CUDA events, {card})")

    # 3-7. the main path: train steps, a val step, the policies, the evaluator
    rng = np.random.default_rng(seed + 43)
    batch = synthetic_fused_batch(cfg, BATCH_PER_MOD, SEQ, seed, "cuda")
    val_batch = split_fused(batch)
    lang = rng.normal(size=cfg.lang_dim).astype(np.float32)
    single_obs = make_obs(rng, cfg, MCIL_STEPS_FIRST + MCIL_STEPS_AFTER_RESET)
    langs = rng.normal(size=(lanes, cfg.lang_dim)).astype(np.float32)
    batched_obs = [make_obs(rng, cfg, lanes) for _ in range(MCIL_STEPS_FIRST + MCIL_STEPS_AFTER_RESET)]
    trainer = Trainer(cfg, TrainerConfig(seed=seed), "cuda")
    trainer.model.load_state_dict(model.state_dict())
    trainer.init_state(1)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step_losses, host, events = drive_training(trainer, batch, cfg.loss.kl_beta, train_steps)
    per_step = launch_counts()
    trainer.model.eval()
    with torch.no_grad():
        val = trainer.val_step(val_batch, cfg.loss.kl_beta, generator=torch.Generator(device="cuda").manual_seed(seed))
    trainer.model.train()
    single_actions, single_states, k_plans = drive_mcil_single(cfg, model, single_obs, lang, seed)
    batched_actions, batched_states = drive_batched(cfg, model, batched_obs, langs, seed)
    with tempfile.TemporaryDirectory() as tmp:
        evaluator, _, _ = run_batched(cfg, BatchedHulcPolicy(cfg, model, lanes, seed=seed), MCIL_EVAL_CHAINS,
                                      MCIL_EVAL_EP_LEN, seed, tmp)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"[mcil main path] launches: {launches}")
    if not all(launches[k] > 0 for k in MCIL_KERNELS):
        fail(f"a kernel of the mcil path was never launched: {launches}")
    if any(launches[k] for k in MCIL_NOT_REACHED):
        fail(f"the mcil path launched the discrete plan's kernels: {launches}")
    layers = cfg.plan_recognition.birnn_num_layers
    want = {"hulc_rnn_tanh_fwd": 2 * layers, "hulc_rnn_tanh_bwd": 2 * layers, "hulc_birnn_tanh_fwd": layers,
            "hulc_birnn_tanh_bwd": layers}
    if any(per_step[k] != n * train_steps for k, n in want.items()):
        fail(f"{train_steps} mcil train steps launched B.8 / B.9 {({k: per_step[k] for k in want})}, not "
             f"{({k: n * train_steps for k, n in want.items()})}: a train step runs each layer's two chains once")
    for i, losses in enumerate(step_losses):
        if not all(np.isfinite(v) for v in losses.values()):
            fail(f"mcil train step {i}: a loss is not finite: {losses}")
    if not all(np.isfinite(float(v)) for v in val.values()):
        fail(f"mcil val step: a metric is not finite: {val}")
    print("[mcil main path] " + "; ".join(
        f"step {i}: total {l['total_loss']:.5f} action {l['action_loss']:.5f} kl {l['kl_loss']:.6f} "
        f"grad_norm {l['grad_norm']:.5f}" for i, l in enumerate(step_losses)))
    step_ms, event_ms_ = statistics.median(host[2:]), statistics.median(events[2:])
    print(f"[timing] mcil train step (2B={2 * BATCH_PER_MOD}, S={SEQ}, median of {len(host) - 2} after 2 warm-ups): "
          f"host clock {step_ms:.4f} ms, CUDA events {event_ms_:.4f} ms, {2 * BATCH_PER_MOD / step_ms * 1e3:.2f} seq/s; "
          f"all steps host {[round(t, 4) for t in host]} ms ({card})")
    check_actions("mcil single lane", single_actions, 1, discrete_gripper=False)
    check_actions("mcil batched", batched_actions, lanes, discrete_gripper=False)
    print(f"[mcil main path] evaluate_policy_batched: {evaluator['lanes']} lanes, {evaluator['chains']} chains, ep_len "
          f"{evaluator['ep_len']}: {evaluator['lockstep_iters']} lockstep iterations, {evaluator['env_steps']} env steps "
          f"in {evaluator['wall_s']:.4f} s, {evaluator['env_steps_per_s']:.2f} env-steps/s, avg_seq_len "
          f"{evaluator['results']['avg_seq_len']} ({card})")
    del trainer

    # the main path against the plain path
    train_check = compare_train_plain(cfg, model, batch, seed, label="mcil train plain path")
    val_trainer = Trainer(cfg, TrainerConfig(seed=seed), "cuda")
    val_trainer.model.load_state_dict(model.state_dict())
    val_check = compare_val_plain(cfg, val_trainer, seed, val_batch, label="mcil")
    del val_trainer
    plain_model = make_model(cfg, "cuda", seed=seed, use_kernels=False)
    plain_model.load_state_dict(model.state_dict())
    p_actions, p_plans = plain_mcil_single(cfg, plain_model, single_obs, lang, seed, single_states)
    replanned = np.array([t % cfg.replan_freq == 0 for t in range(MCIL_STEPS_FIRST)]
                         + [t % cfg.replan_freq == 0 for t in range(MCIL_STEPS_AFTER_RESET)])
    single_err = compare_plain("mcil single lane, across a replan and a reset", single_actions, p_actions, k_plans,
                               p_plans, replanned, cfg)
    masks = [replan_mask(t, lanes, cfg.replan_freq) for t in range(len(batched_obs))]
    p_actions, p_plans = plain_batched(
        cfg, plain_model, list(zip(batched_obs, [langs] * len(batched_obs), batched_states, masks)), seed)
    k_plans = np.stack([s[0].cpu().numpy() for s in batched_states[1:]])
    batched_err = compare_plain(f"mcil batched, {lanes} lanes", batched_actions, p_actions, k_plans, p_plans,
                                np.stack(masks), cfg)
    del plain_model

    # 6. the serving export at --lanes lanes, served in a process without model code
    export, served_launches = run_serving_export({"mcil": (cfg, model, SERVING_KERNELS)}, seed, lanes,
                                                 single_obs[:MCIL_STEPS_FIRST], lang, batched_obs, langs, card,
                                                 with_debug=False)
    del model
    torch.cuda.empty_cache()
    summary = {
        "parameters": n_params, "train_step": {"host_ms": step_ms, "event_ms": event_ms_, "steps_host_ms": host,
                                               "plain_path": train_check},
        "val_step": val_check, "policy_plain_max_abs_err": {"1": single_err, str(lanes): batched_err},
        "evaluator": {k: evaluator[k] for k in ("lanes", "chains", "ep_len", "lockstep_iters", "env_steps",
                                                "env_steps_per_s", "wall_s")},
        "serving_export": export, "card": card,
    }
    return summary, launches, errs, timing


# --------------------------------------------------------------------------
# phase 15: hulc_depth at full width
# --------------------------------------------------------------------------

DEPTH_PARAMS = 50_293_559  # JAX's count for hulc_depth, initialized on a batch with depth frames
# B.10's two modes: the static depth camera's gamma noise, the gripper's gaussian noise (std 0.01)
DEPTH_MODES = (("depth_static", "gamma", 0.0), ("depth_gripper", "gaussian", 0.01))
# a hulc_depth train step's launches of B.10 (one per depth camera) and of
# B.2 / B.2' (the RGB and the depth static towers)
DEPTH_STEP_LAUNCHES = {"hulc_depth_noise": 2, "hulc_spatial_softmax": 2, "hulc_spatial_softmax_bwd": 2}
DEPTH_FIT_EPOCHS, DEPTH_FIT_STEPS, DEPTH_FIT_VAL_BATCHES = 2, 2, 1
DEPTH_RESUME_EPOCHS = 2  # the resume check's whole run: one step an epoch; the cut run one step, the resumed one
DEPTH_RESUME_STEPS = 2 * DEPTH_RESUME_EPOCHS  # train steps of the three runs


# B.10's draw mode: its normals within this of the plain Box-Muller on its
# own words (PyTorch's and the card's log / sin / cos differ by an ulp or two,
# times |z| up to 6.7), and the moments of the step's 96.3 M normals
DRAW_Z_ATOL = 1e-5
DRAW_MEAN_ATOL, DRAW_VAR_ATOL, DRAW_TAIL_SHARE = 1e-3, 2e-3, (2e-5, 2e-4)  # |z| > 4: 6.3e-5 for a normal
DRAW_WORD_SAMPLE = 1 << 20  # the static camera's groups whose words numpy's Philox recomputes


def check_depth_draw(x, mode, std, gen, shape):
    """B.10's draw mode at the train step's shape: its debug launch's words
    against numpy's Philox (every group at the gripper's size, DRAW_WORD_SAMPLE
    random groups, the first and the last of the static camera's), its
    frames bit-equal to ``prep_depth_plain`` on the normals it wrote, the
    normals within DRAW_Z_ATOL of the plain Box-Muller of its words, each of
    a two-rank split's blocks of rows (two row blocks, as a fused batch)
    bit-equal to the global draw's rows, two consecutive
    ``draw_depth_noise`` calls differing and a restored generator state
    repeating. Returns (its normals, max |y - plain y|, max |z - plain z|)."""
    from hulc_tpu_torch.ops.depth_noise import (DRAW_OFFSET_STEP, box_muller_plain, draw_depth_noise, draw_key,
                                                draw_layout, philox4x32_10, prep_depth_draw, prep_depth_plain)
    from hulc_tpu_torch.parallel.mesh import rows_of

    seed, offset = gen.initial_seed(), gen.get_offset()
    y, z, words = prep_depth_draw(x, mode, std, seed, offset, debug=True)
    torch.cuda.synchronize()
    layout = draw_layout(shape)
    groups = layout.groups
    if x.numel() > 4 * DRAW_WORD_SAMPLE:
        pick = np.random.default_rng(0).choice(len(groups), DRAW_WORD_SAMPLE, replace=False)
        pick = np.unique(np.concatenate([pick, [0, len(groups) - 1]]))
    else:
        pick = np.arange(len(groups))
    g, off = groups[pick], np.uint64(offset)
    mask = np.uint64(0xFFFFFFFF)
    want = philox4x32_10((g & mask, g >> np.uint64(32), off & mask, off >> np.uint64(32)), draw_key(seed)).T
    got = words.reshape(-1, 4)[torch.from_numpy(pick).cuda()].cpu().numpy().astype(np.uint32)
    if not np.array_equal(got, want):
        fail(f"B.10 draw ({mode}) at {shape}: {int((got != want).any(1).sum())} of {len(pick)} groups' Philox words "
             f"differ from numpy's")
    if not torch.equal(y, prep_depth_plain(x, z, mode, std)):
        fail(f"B.10 draw ({mode}) at {shape}: the frames are not prep_depth_plain on its own normals")
    plain_z = box_muller_plain(words.reshape(-1)).reshape(shape)
    z_err = max_abs(z, plain_z)
    y_err = max_abs(y, prep_depth_plain(x, plain_z, mode, std))
    del plain_z, words
    if not z_err <= DRAW_Z_ATOL:
        fail(f"B.10 draw ({mode}) at {shape}: normals {z_err:.3g} from the plain Box-Muller (at most {DRAW_Z_ATOL})")
    for r in range(2):
        local = rows_of(x, 2, 2, r).contiguous()
        if not torch.equal(prep_depth_draw(local, mode, std, seed, offset, (2, 2, r)), rows_of(y, 2, 2, r)):
            fail(f"B.10 draw ({mode}) at {shape}: rank {r} of 2's rows differ from the global draw's")
    state = gen.get_state()
    first, second = (draw_depth_noise(x, mode, std, gen) for _ in range(2))
    if gen.get_offset() != offset + 2 * DRAW_OFFSET_STEP or torch.equal(first, second):
        fail(f"B.10 draw ({mode}): two calls moved the offset {offset} -> {gen.get_offset()} or drew the same noise")
    gen.set_state(state)
    if not torch.equal(draw_depth_noise(x, mode, std, gen), first):
        fail(f"B.10 draw ({mode}): a restored generator state did not draw the same noise")
    return z, y_err, z_err


def check_depth_noise(cfg, seed, card):
    """B.10 in both modes at the train step's shapes. The z mode (the
    caller's draw) against its plain version bit for bit (also writing into
    the draw's buffer, and at an odd size, 945 elements, n % 4 = 1, on bases
    4 bytes off 16-byte alignment). The draw mode (``check_depth_draw``),
    and the moments of its normals over both cameras' 96.3 M draws. Then
    the device times by CUDA events with the host's launch cost kept out
    (``kernel_times.event_ms``: late in this process the profiler drops
    most of these launches): the draw mode, its plain version (one call,
    host clock: numpy's Philox on the host), its bound (8 bytes an
    element), and what the step ran before, ``torch.randn`` and the z mode's
    launch; for the gaussian mode ``torch.randn`` + ``torch.add(x, z,
    alpha=std)`` (its library call). Returns ({row: max abs err}, {row:
    timing})."""
    from hulc_tpu_torch.evaluation.kernel_times import event_ms
    from hulc_tpu_torch.ops.depth_noise import prep_depth, prep_depth_draw, prep_depth_draw_plain, prep_depth_plain
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ

    gen = torch.Generator(device="cuda").manual_seed(seed + 61)
    pe = cfg.perceptual_encoder
    timing, library_err, zs, errs = {}, {}, [], {}
    for cam, mode, std in DEPTH_MODES:
        px = getattr(pe, cam).input_size
        shape = (2 * BATCH_PER_MOD, SEQ, px, px)
        x = 0.1 + 4.9 * torch.rand(shape, generator=gen, device="cuda")
        z = torch.randn(shape, generator=gen, device="cuda")
        want = prep_depth_plain(x, z, mode, std)
        if not torch.equal(prep_depth(x, z, mode, std), want):
            fail(f"depth noise kernel ({mode}) at {shape}: max abs err {max_abs(prep_depth(x, z, mode, std), want)}")
        zc = z.clone()
        if not (prep_depth(x, zc, mode, std, out=zc) is zc and torch.equal(zc, want)):
            fail(f"depth noise kernel ({mode}) at {shape}, written into the draw's buffer, differs from its plain version")
        odd = (3, 5, 7, 9)
        xo, zo = (t.reshape(-1)[1:1 + 945].reshape(odd) for t in (x, z))
        if not (xo.data_ptr() % 16 and torch.equal(prep_depth(xo, zo, mode, std), prep_depth_plain(xo, zo, mode, std))):
            fail(f"depth noise kernel ({mode}) at {odd}, 4 bytes off alignment, differs from its plain version")
        del zc, want
        drawn, y_err, z_err = check_depth_draw(x, mode, std, gen, shape)
        zs.append(drawn.reshape(-1))
        errs[mode] = (y_err, z_err)
        out = torch.empty_like(x)
        n = x.numel()
        s0, off = gen.initial_seed(), gen.get_offset()
        t_bound, by = bound(2 * 4 * n, (5 if mode == "gamma" else 2) * n)
        t0 = time.perf_counter()
        prep_depth_draw_plain(x, mode, std, s0, off)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        row = {
            "shape": list(shape), "mode": mode,
            "ms": event_ms(lambda: prep_depth_draw(x, mode, std, s0, off, out=out)),
            "plain_ms": plain_s * 1e3, "plain_how": "one call, host clock to a sync (numpy's Philox on the host)",
            "call_ms": call_ms(lambda: prep_depth_draw(x, mode, std, s0, off, out=out), 20),
            "z_mode_ms": event_ms(lambda: prep_depth(x, z, mode, std, out=out)),
            "z_mode_plain_ms": event_ms(lambda: prep_depth_plain(x, z, mode, std)),
            "randn_ms": event_ms(lambda: torch.randn(shape, generator=gen, device="cuda")),
            "randn_z_mode_ms": event_ms(
                lambda: prep_depth(x, torch.randn(shape, generator=gen, device="cuda"), mode, std, out=out)),
            "bound_ms": t_bound, "bound_by": by, "library_ms": None,
            "max_abs_err_y": y_err, "max_abs_err_z": z_err,
        }
        if mode == "gaussian":
            row["library_ms"] = event_ms(lambda: torch.add(x, torch.randn(shape, generator=gen, device="cuda"),
                                                           alpha=std))
            row["library_call"] = "torch.randn + torch.add(x, z, alpha=std)"
            library_err[mode] = max_abs(torch.add(x, z, alpha=std), prep_depth_plain(x, z, mode, std))
        timing["depth_noise" if mode == "gamma" else "depth_noise_gaussian"] = row
        del x, z, out, drawn
        torch.cuda.empty_cache()
    z = torch.cat(zs)
    mean, var = float(z.double().mean()), float(z.double().var())
    tail = float((z.abs() > 4).double().mean())
    print(f"[depth] B.10 draw mode over the step's {z.numel()} normals: mean {mean:.3g}, variance {var:.6f}, share "
          f"|z| > 4 {tail:.3g}")
    if not (abs(mean) <= DRAW_MEAN_ATOL and abs(var - 1) <= DRAW_VAR_ATOL
            and DRAW_TAIL_SHARE[0] <= tail <= DRAW_TAIL_SHARE[1]):
        fail(f"B.10 draw's normals: mean {mean:.3g} (within {DRAW_MEAN_ATOL}), variance {var:.6f} (within "
             f"{DRAW_VAR_ATOL} of 1), share |z| > 4 {tail:.3g} (in {DRAW_TAIL_SHARE})")
    del z, zs
    torch.cuda.empty_cache()
    for name, t in timing.items():
        lib = "" if t["library_ms"] is None else (
            f", torch.randn + torch.add(x, z, alpha={DEPTH_MODES[1][2]}) {t['library_ms']:.6f} ms (the add alone "
            f"{library_err['gaussian']:.3g} from the plain version: it rounds x + alpha * z once)")
        y_err, z_err = errs[t["mode"]]
        print(f"[depth] B.10 {t['mode']} at {tuple(t['shape'])}: z mode bit-equal to its plain version (also in the "
              f"draw's buffer, and at 945 elements 4 bytes off alignment); draw mode: numpy's Philox words, the frames "
              f"bit-equal to prep_depth_plain on its normals, its normals {z_err:.3g} from the plain Box-Muller (its "
              f"frames {y_err:.3g}), a 2-rank split and a restored state bit-equal; CUDA events: draw {t['ms']:.6f} ms "
              f"(bound {t['bound_ms']:.6f} ms, {t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.1f}% of it), "
              f"torch.randn {t['randn_ms']:.6f} + z mode {t['z_mode_ms']:.6f} ms, in turn "
              f"{t['randn_z_mode_ms']:.6f} ms{lib}; the draw's plain version {t['plain_ms']:.3f} ms (one call), the z "
              f"mode's {t['z_mode_plain_ms']:.6f} ms; per call with the host's launch cost {t['call_ms']:.5f} ms "
              f"({card})")
    return {"depth_noise": max(e[0] for e in errs.values())}, timing


def check_depth_resume(cfg, seed, batches, root, tmp):
    """``fit`` for DEPTH_RESUME_EPOCHS epochs of one step on ``batches`` (one
    host batch an epoch), and the same run cut after its first step and
    resumed by a new Trainer, both on cuDNN's deterministic algorithms: the
    parameters, the Adam state, the step and the generator (its offset,
    which B.10's draw moves) bit-equal. Returns the seconds it took."""
    from hulc_tpu_torch.data.loader import make_loaders
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    class Epochs:
        """One batch an epoch: batch ``start`` + e in the e-th pass."""

        def __init__(self, start=0):
            self.next = start

        def __len__(self):
            return 1

        def __iter__(self):
            self.next += 1
            return iter([batches[self.next - 1]])

    def trainer(name):
        return Trainer(cfg, TrainerConfig(run_dir=str(tmp / name), seed=seed, log_every=1, val_max_batches=1), "cuda")

    def val():
        return make_loaders(cfg, root, split="validation", batch_size=FIT_BATCH, deterministic=True)

    t0 = time.perf_counter()
    with deterministic_cudnn():
        whole = trainer("whole")
        steps = [whole.fit(Epochs(), val(), max_epochs=DEPTH_RESUME_EPOCHS)]
        steps.append(trainer("cut").fit(Epochs(), val(), max_epochs=DEPTH_RESUME_EPOCHS, max_steps=1))
        torch.cuda.empty_cache()
        resumed = trainer("cut")
        steps.append(resumed.fit(Epochs(start=1), val(), max_epochs=DEPTH_RESUME_EPOCHS))
    if steps != [DEPTH_RESUME_EPOCHS, 1, DEPTH_RESUME_EPOCHS]:
        fail(f"hulc_depth resume: the whole, cut and resumed fits ended at steps {steps}")
    for (k, a), (_, b) in zip(whole.model.state_dict().items(), resumed.model.state_dict().items()):
        if not torch.equal(a, b):
            fail(f"hulc_depth resume: parameter {k} differs between the whole run and the cut-and-resumed one")
    opt_a, opt_b = whole.optimizer.checkpoint_state(), resumed.optimizer.checkpoint_state()
    if opt_a["count"] != opt_b["count"] or not all(
        torch.equal(x, y) for key in ("exp_avg", "exp_avg_sq") for x, y in zip(opt_a[key], opt_b[key])
    ):
        fail("hulc_depth resume: the Adam state differs between the whole run and the cut-and-resumed one")
    if whole.step != resumed.step or not torch.equal(whole.generator.get_state(), resumed.generator.get_state()):
        fail("hulc_depth resume: the step or the generator state differs")
    took = time.perf_counter() - t0
    print(f"[depth fit] {DEPTH_RESUME_EPOCHS} epochs of one step, and the same cut after one step and resumed by a "
          f"new Trainer (cuDNN deterministic): parameters, Adam moments, step and generator (offset "
          f"{resumed.generator.get_offset()}) bit-equal, in {took:.1f} s")
    del whole, resumed
    torch.cuda.empty_cache()
    return took


def run_depth_fit(cfg, seed, card):
    """``Trainer.fit`` at full width on a 200 / 84 px fixture with depth
    frames: DEPTH_FIT_EPOCHS epochs of DEPTH_FIT_STEPS steps, one loader
    worker, the batches through the trainer's DeviceLoader, validation
    (DEPTH_FIT_VAL_BATCHES an epoch) and checkpoints, under torch.profiler
    for the device's idle share; then three fused batches with their depth
    frames uploaded back to back through the trainer's staging slots,
    byte-equal on the device (``check_upload``). Returns (report, {kernel:
    launches in validation})."""
    from torch.profiler import ProfilerActivity, profile

    from hulc_tpu_torch.data.fixtures import make_fixture_dataset
    from hulc_tpu_torch.data.loader import make_loaders
    from hulc_tpu_torch.evaluation.profile_policy import WINDOW_PAD_S, device_events, device_ms as events_ms, kind_of
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        root = make_fixture_dataset(tmp / "data", num_episodes=FIT_EPISODES, episode_len=FIT_EPISODE_LEN,
                                    small=False, seed=seed)
        write_s = time.perf_counter() - t0
        train = make_loaders(cfg, root, batch_size=FIT_BATCH, fuse=True, seed=seed, num_workers=1)
        val = make_loaders(cfg, root, split="validation", batch_size=FIT_BATCH, deterministic=True)
        host = train._make()["fused"]
        for cam, px in (("depth_static", 200), ("depth_gripper", 84)):
            d = getattr(host, cam)
            if d is None or d.dtype != np.float32 or d.shape != (2 * FIT_BATCH, 32, px, px):
                fail(f"the fused fixture batch's {cam} is {None if d is None else (d.dtype, d.shape)}")
        batch_mb = sum(t.nbytes for t in host if t is not None) / 1e6
        trainer = Trainer(cfg, TrainerConfig(run_dir=str(tmp / "run"), seed=seed, log_every=1,
                                             val_max_batches=DEPTH_FIT_VAL_BATCHES), "cuda")
        val_launches, val_calls = collections.Counter(), []
        count_validation(trainer, val_launches, val_calls)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(WINDOW_PAD_S)  # the profiler drops device activity at a window's edges
            t0 = time.perf_counter()
            steps = trainer.fit(FirstBatches(train, DEPTH_FIT_STEPS), val, max_epochs=DEPTH_FIT_EPOCHS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(WINDOW_PAD_S)
        if steps != DEPTH_FIT_EPOCHS * DEPTH_FIT_STEPS:
            fail(f"hulc_depth fit took {steps} steps, expected {DEPTH_FIT_EPOCHS * DEPTH_FIT_STEPS}")
        events = device_events(prof)
        busy = events_ms([e for e in events if kind_of(e.key) != "copies and fills"])
        copies = events_ms([e for e in events if kind_of(e.key) == "copies and fills"])
        recorded = sum(e.count for e in events if "depth_noise" in e.key)
        records = [json.loads(line) for line in (tmp / "run" / "metrics.jsonl").read_text().splitlines()]
        if {r["prefix"] for r in records} != {"train", "val", "epoch"}:
            fail(f"hulc_depth fit: metrics.jsonl has the prefixes {sorted({r['prefix'] for r in records})}")
        for r in records:
            if not all(np.isfinite(v) for k, v in r.items() if k != "prefix"):
                fail(f"hulc_depth fit: a value in metrics.jsonl is not finite: {r}")
            if r["prefix"] == "val" and sorted(set(r) - {"step", "prefix"}) != VAL_KEYS:
                fail(f"hulc_depth fit: the val line's keys are not JAX's {VAL_KEYS}")
        epochs = [r for r in records if r["prefix"] == "epoch"]
        upload = check_upload(trainer, [train._make() for _ in range(3)], label="depth fit")
        del trainer
        torch.cuda.empty_cache()
        resume_s = check_depth_resume(cfg, seed, [train._make() for _ in range(DEPTH_RESUME_EPOCHS)], root, tmp)
    report = {"fixture_write_s": write_s, "batch_mb": batch_mb, "steps": steps, "wall_ms": wall_ms,
              "kernel_busy_ms": busy, "copy_ms": copies, "idle_share": 1.0 - busy / wall_ms,
              "profiled_depth_noise_launches": recorded, "upload_check": upload, "resume_check_s": resume_s,
              "epochs": [{k: r[k] for k in ("epoch_time_s", "seq_per_sec")} for r in epochs]}
    print(f"[depth fit] fit on a 200 / 84 px fixture with depth frames ({FIT_EPISODES} episodes of {FIT_EPISODE_LEN} "
          f"frames written in {write_s:.2f} s; fused batches of 2x{FIT_BATCH} windows of 32 frames, {batch_mb:.1f} MB, "
          f"one loader worker, through the DeviceLoader): {DEPTH_FIT_EPOCHS} epochs of {DEPTH_FIT_STEPS} steps with "
          f"validation ({DEPTH_FIT_VAL_BATCHES} batch an epoch) and checkpoints in {wall_ms:.4f} ms under "
          f"torch.profiler; epochs {[round(r['seq_per_sec'], 3) for r in epochs]} seq/s (train steps only, first "
          f"epoch with the first upload); kernels busy {busy:.4f} ms, copies and fills {copies:.4f} ms, device idle "
          f"{100 * report['idle_share']:.2f}% of the wall; the profiler recorded {recorded} of the "
          f"{2 * steps} B.10 launches{'' if recorded == 2 * steps else ', so busy is short of the truth'} ({card})")
    return report, dict(val_launches)


@contextlib.contextmanager
def randn_shapes():
    """Inside, every ``torch.randn`` call's shape is recorded in the yielded set."""
    drawn, randn = set(), torch.randn

    def recorded(*size, **kw):
        shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else tuple(size)
        drawn.add(shape)
        return randn(*size, **kw)

    torch.randn = recorded
    try:
        yield drawn
    finally:
        torch.randn = randn


def run_depth(seed, train_steps, card):
    """Phase 15: the ``hulc_depth`` model at full width. Returns (summary,
    {kernel symbol: launches on the main path}, {row: max abs err}, {row:
    timing})."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.config import get_config
    from hulc_tpu_torch.models import make_model
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ, synthetic_fused_batch
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = get_config("hulc_depth")
    model = make_model(cfg, "cuda", seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != DEPTH_PARAMS:
        fail(f"the hulc_depth model has {n_params} parameters, JAX's has {DEPTH_PARAMS}")
    pe = cfg.perceptual_encoder
    print(f"[depth] hulc_depth preset, {n_params} parameters, random init from seed {seed}: RGB and depth towers at "
          f"{pe.rgb_static.input_size} / {pe.rgb_gripper.input_size} px, a {pe.latent_size}-d latent, the decoder on "
          f"{cfg.action_decoder.perceptual_emb_slice}")

    # 1. B.10 against its plain version, and its times
    errs, timing = check_depth_noise(cfg, seed, card)

    # 2-4. the main path: train steps, a val step, fit
    batch = synthetic_fused_batch(cfg, BATCH_PER_MOD, SEQ, seed, "cuda")
    val_batch = split_fused(batch)
    trainer = Trainer(cfg, TrainerConfig(seed=seed), "cuda")
    trainer.model.load_state_dict(model.state_dict())
    trainer.init_state(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with randn_shapes() as drawn:
        step_losses, host, events = drive_training(trainer, batch, cfg.loss.kl_beta, train_steps)
    per_step = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    depth_shapes = {tuple(getattr(batch["fused"], cam).shape) for cam, _, _ in DEPTH_MODES}
    if any(shape in depth_shapes for shape in drawn):
        fail(f"the hulc_depth train steps drew torch.randn over the depth frames: {sorted(drawn)}")
    trainer.model.eval()
    with torch.no_grad():
        val = trainer.val_step(val_batch, cfg.loss.kl_beta, generator=torch.Generator(device="cuda").manual_seed(seed))
    trainer.model.train()
    torch.cuda.synchronize()
    val_launches = {k: n - per_step[k] for k, n in launch_counts().items()}
    del trainer
    torch.cuda.empty_cache()
    fit, fit_val_launches = run_depth_fit(cfg, seed, card)
    launches = launch_counts()
    print(f"[depth main path] launches: {launches}")
    if not all(per_step[k] > 0 for k in TRAIN_KERNELS):
        fail(f"a kernel of the training path was never launched by the hulc_depth train steps: {per_step}")
    if any(per_step[k] != n * train_steps for k, n in DEPTH_STEP_LAUNCHES.items()):
        fail(f"{train_steps} hulc_depth train steps launched {({k: per_step[k] for k in DEPTH_STEP_LAUNCHES})}, not "
             f"{({k: n * train_steps for k, n in DEPTH_STEP_LAUNCHES.items()})}")
    if val_launches["hulc_depth_noise"] or fit_val_launches.get("hulc_depth_noise", 0):
        fail(f"validation launched the depth noise kernel: the val step {val_launches['hulc_depth_noise']} times, "
             f"fit's validation {fit_val_launches.get('hulc_depth_noise', 0)} times")
    if launches["hulc_depth_noise"] != 2 * (train_steps + DEPTH_FIT_EPOCHS * DEPTH_FIT_STEPS + DEPTH_RESUME_STEPS):
        fail(f"the depth noise kernel launched {launches['hulc_depth_noise']} times on the hulc_depth path")
    for i, losses in enumerate(step_losses):
        if not all(np.isfinite(v) for v in losses.values()):
            fail(f"hulc_depth train step {i}: a loss is not finite: {losses}")
    if not all(np.isfinite(float(v)) for v in val.values()):
        fail(f"hulc_depth val step: a metric is not finite: {val}")
    print("[depth main path] " + "; ".join(
        f"step {i}: total {l['total_loss']:.5f} action {l['action_loss']:.5f} kl {l['kl_loss']:.6f} "
        f"clip {l['lang_clip_loss']:.5f} grad_norm {l['grad_norm']:.5f}" for i, l in enumerate(step_losses)))
    step_ms, event_ms_ = statistics.median(host[2:]), statistics.median(events[2:])
    print(f"[timing] hulc_depth train step (2B={2 * BATCH_PER_MOD}, S={SEQ}, median of {len(host) - 2} after 2 "
          f"warm-ups): host clock {step_ms:.4f} ms, CUDA events {event_ms_:.4f} ms, "
          f"{2 * BATCH_PER_MOD / step_ms * 1e3:.2f} seq/s; all steps host {[round(t, 4) for t in host]} ms; peak "
          f"memory {peak_gb:.2f} GB; the val step launched B.10 {val_launches['hulc_depth_noise']} times; "
          f"torch.randn over no depth frame (its shapes {sorted(drawn)}) ({card})")

    # the main path against the plain path
    train_check = compare_train_plain(cfg, model, batch, seed, label="hulc_depth train plain path")
    val_trainer = Trainer(cfg, TrainerConfig(seed=seed), "cuda")
    val_trainer.model.load_state_dict(model.state_dict())
    val_check = compare_val_plain(cfg, val_trainer, seed, val_batch, label="hulc_depth")
    del val_trainer, model, batch, val_batch
    torch.cuda.empty_cache()
    summary = {
        "parameters": n_params,
        "train_step": {"host_ms": step_ms, "event_ms": event_ms_, "steps_host_ms": host,
                       "seq_per_s": 2 * BATCH_PER_MOD / step_ms * 1e3, "peak_memory_gb": peak_gb,
                       "plain_path": train_check},
        "val_step": {**val_check, "depth_noise_launches": val_launches["hulc_depth_noise"]},
        "fit": fit, "card": card, "s": time.perf_counter() - t_phase,
    }
    print(f"[depth] phase 15 in {summary['s']:.1f} s")
    return summary, launches, errs, timing


# --------------------------------------------------------------------------
# phase 16: the decoder's gru and lstm cells at full width
# --------------------------------------------------------------------------

HULC_PARAMS = 47_053_559  # JAX's count for hulc, its decoder the relu RNN
GATED_CELLS = ("gru", "lstm")
# each cell's kernels, forward and dh chain (B.11, B.12)
GATED_SYMBOLS = {"gru": ("hulc_rnn_gru_fwd", "hulc_rnn_gru_bwd"), "lstm": ("hulc_rnn_lstm_fwd", "hulc_rnn_lstm_bwd")}
GATED_TRAIN_STEPS = 3  # two warm-ups and one timed
GATED_SINGLE_STEPS, GATED_RESET_AT = 4, 2  # single lane: replans at 0 and, after a reset, at 2
GATED_LOCKSTEP_STEPS = 3  # the lockstep policy: every lane plans at 0, some at 1 and 2


def gated_config(cell):
    """``hulc`` with the decoder cell set as a user sets it: apply_overrides."""
    from hulc_tpu_torch.config import apply_overrides, get_config

    return apply_overrides(get_config("hulc"), [f"action_decoder.rnn_cell={cell}"])


def gated_case(cell, b, s, h, gen, w=None, bias=None):
    """Inputs of one gated layer: xp ~ N(0, 1) (B, S, G H), a nonzero carry
    (h0 a tanh of N(0, 1); c0 of N(0, 1) for lstm), W_hh and b_hh (given,
    or torch's U(-1/sqrt(H), 1/sqrt(H))), and nonzero cotangents for y and
    the final carry."""
    from hulc_tpu_torch.ops.recurrence import GATES

    g = GATES[cell]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def uniform(*shape):
        return (2.0 * torch.rand(shape, generator=gen, device="cuda") - 1.0) / h**0.5

    w = uniform(g * h, h) if w is None else w
    bias = uniform(g * h) if bias is None else bias
    states = (torch.tanh(randn(b, h)),) + ((randn(b, h),) if cell == "lstm" else ())
    dcarry = tuple(randn(b, h) for _ in states)
    return randn(b, s, g * h), states, w, bias, randn(b, s, h), dcarry


def check_gated_case(cell, xp, states, w, bias, dy, dcarry, where):
    """B.11 / B.12 on one layer against their plain versions, each within
    REC_REL relative L2: the inference forward (y, the final h and c); the
    training forward (y and the saved gates); the dh chain on the same
    inputs, the carry's cotangents nonzero; and the autograd Function's
    gradients of xp, the carry, W_hh and b_hh against the closed form and
    against autograd through the plain loop. Returns (largest absolute
    error of the forward's outputs, of the backward's)."""
    from hulc_tpu_torch.ops import recurrence as rec

    lstm = cell == "lstm"
    shape = tuple(dy.shape)
    c0 = states[1] if lstm else None
    errs, fwd_abs = {}, 0.0
    kernel_fwd = rec.rnn_lstm_fwd_kernel if lstm else rec.rnn_gru_fwd_kernel
    y_p, c_p, saved_p = rec._gated_loop(cell, xp, states[0], c0, w, bias, True)
    for save in (False, True):
        out = kernel_fwd(xp, *states, w, bias, save=save)
        wants = (y_p, y_p[:, -1], *((c_p,) if lstm else ()), *((saved_p,) if save else ()))
        for name, g, r in zip(("y", "h_last", *(("c_last",) if lstm else ()), "saved"), out, wants):
            errs[f"{'train' if save else 'inference'} {name}"] = rel_l2(g, r)
            fwd_abs = max(fwd_abs, max_abs(g, r))
    if lstm:
        kern = rec.rnn_lstm_bwd(dy, *dcarry, saved_p, c0, w)
        plain = rec.dh_chain_lstm_plain(dy, *dcarry, saved_p, c0, w)
        names = ("dpre", "dh0", "dc0")
    else:
        kern = rec.rnn_gru_bwd(dy, dcarry[0], y_p, states[0], saved_p, w)
        plain = rec.dh_chain_gru_plain(dy, dcarry[0], y_p, states[0], saved_p, w)
        names = ("dxp", "dhp", "dh0")
    for name, g, r in zip(names, kern, plain):
        errs[f"{name} kernel vs plain"] = rel_l2(g, r)
    inputs = (xp, *states, w, bias)
    leaves = [t.clone().requires_grad_() for t in inputs]
    fn = rec.rnn_lstm if lstm else rec.rnn_gru
    k_grads = torch.autograd.grad(fn(*leaves), leaves, [dy, *dcarry])
    leaves = [t.clone().requires_grad_() for t in inputs]
    y, c, _ = rec._gated_loop(cell, leaves[0], leaves[1], leaves[2] if lstm else None, leaves[-2], leaves[-1], False)
    auto = torch.autograd.grad([y, y[:, -1], *((c,) if lstm else ())], leaves, [dy, *dcarry])
    # the Function's closed form: the dh chain's dxp and carry gradients, then dW_hh and db_hh from dhp
    dhp = plain[0] if lstm else plain[1]
    closed = (plain[0], *plain[1 + (not lstm):], *rec.recurrence_weight_grads(dhp, states[0], y_p))
    for ref, wants in (("closed form", closed), ("autograd", auto)):
        for n, g, r in zip(("dxp", "dh0", *(("dc0",) if lstm else ()), "dW_hh", "db_hh"), k_grads, wants):
            errs[f"{n} vs {ref}"] = rel_l2(g, r)
    if not max(errs.values()) <= REC_REL:
        fail(f"{cell} recurrence at {where} {shape}: relative L2 {errs}")
    bwd_abs = max(max_abs(g, r) for g, r in (*zip(kern, plain), *zip(k_grads, auto)))
    print(f"[gated] {'B.12' if lstm else 'B.11'} ({cell}) at {where} {shape}: forward (inference and training) relative "
          f"L2 up to {max(v for k, v in errs.items() if 'train' in k or 'inference' in k):.3g}, max abs err "
          f"{fwd_abs:.3g}; dh chain and gradients relative L2 up to {max(errs.values()):.3g}, max abs err {bwd_abs:.3g}")
    return fwd_abs, bwd_abs


def check_gated(cell, model, seed):
    """The cell's two kernels against their plain versions: at the train
    step's (64, 32, 2048) on each decoder layer's W_hh and b_hh, at an odd
    (3, 5, 37) (H not a multiple of 4: the ring filled by plain loads, one
    block a cluster, its one chunk past H), two row tiles
    (96, 3, 64), and one step at 1 and 64 lanes (the one-step GEMV launch,
    and a one-step sequence launch). Returns {kernel row: max abs err}."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 71)
    rnn = model.action_decoder.rnn
    fwd, bwd = f"rnn_{cell}_fwd", f"rnn_{cell}_bwd"
    errs = {fwd: 0.0, bwd: 0.0}
    cases = [((DECODER_ROWS, DECODER_SEQ, rnn.hidden_size), f"the train step, layer {k}",
              (getattr(rnn, f"weight_hh_l{k}").detach(), getattr(rnn, f"bias_hh_l{k}").detach()))
             for k in range(rnn.num_layers)]
    cases += [((3, 5, 37), "an odd shape", (None, None)), ((96, 3, 64), "two row tiles", (None, None)),
              ((1, 1, rnn.hidden_size), "one serving lane", cases[1][2]),
              ((64, 1, rnn.hidden_size), "64 serving lanes", cases[1][2])]
    for (b, s, h), where, (w, bias) in cases:
        e = check_gated_case(cell, *gated_case(cell, b, s, h, gen, w, bias), where)
        errs[fwd], errs[bwd] = max(errs[fwd], e[0]), max(errs[bwd], e[1])
    return errs


def time_gated(cell, model, seed):
    """Device ms of the cell's kernels at the train step's (64, 32, 2048)
    and of the inference forward at 1 and 64 serving lanes, against the
    plain versions and cuDNN's nn.GRU / nn.LSTM of the same weights (W_ih =
    I of G H x G H, b_ih = 0: the same function of xp, plus cuDNN's own
    input projection, timed beside it as one matmul), forward and forward +
    backward (and the backward alone: their difference), by CUDA events in
    turns plain, kernel, kernel, plain; the bound 2 B S H G H fp32 FLOP at
    67 TFLOP/s (one step: the read of W); each launch's plan and the
    kernel's registers a thread (``registers``, from the build's ptxas
    report). The port never calls cuDNN."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.evaluation.kernel_times import event_ms
    from hulc_tpu_torch.ops import recurrence as rec

    lstm = cell == "lstm"
    gen = torch.Generator(device="cuda").manual_seed(seed + 73)
    rnn = model.action_decoder.rnn
    h, b, s = rnn.hidden_size, DECODER_ROWS, DECODER_SEQ
    g = rec.GATES[cell]
    w, bias = rnn.weight_hh_l1.detach(), rnn.bias_hh_l1.detach()
    xp, states, _, _, dy, dcarry = gated_case(cell, b, s, h, gen, w, bias)
    c0 = states[1] if lstm else None
    y, _, saved = rec._gated_loop(cell, xp, states[0], c0, w, bias, True)
    kernel_fwd = rec.rnn_lstm_fwd_kernel if lstm else rec.rnn_gru_fwd_kernel
    if lstm:
        bwd_fn = lambda: rec.rnn_lstm_bwd(dy, *dcarry, saved, c0, w)  # noqa: E731
        bwd_plain = lambda: rec.dh_chain_lstm_plain(dy, *dcarry, saved, c0, w)  # noqa: E731
    else:
        bwd_fn = lambda: rec.rnn_gru_bwd(dy, dcarry[0], y, states[0], saved, w)  # noqa: E731
        bwd_plain = lambda: rec.dh_chain_gru_plain(dy, dcarry[0], y, states[0], saved, w)  # noqa: E731
    lib = (torch.nn.LSTM if lstm else torch.nn.GRU)(g * h, h, batch_first=True, device="cuda")
    with torch.no_grad():
        lib.weight_ih_l0.copy_(torch.eye(g * h, device="cuda"))
        lib.bias_ih_l0.zero_()
        lib.weight_hh_l0.copy_(w)
        lib.bias_hh_l0.copy_(bias)
        lib_states = tuple(t[None] for t in states) if lstm else states[0][None]
        lib_y = lib(xp, lib_states)[0]
        if rel_l2(lib_y, y) > 1e-4:
            fail(f"cuDNN's {cell} does not compute the recurrence: relative L2 {rel_l2(lib_y, y)}")
    lib_in = xp.clone().requires_grad_()

    def lib_train():
        out = lib(lib_in, lib_states)[0]
        torch.autograd.grad(out, [lib_in, *lib.parameters()], dy)

    eye = torch.eye(g * h, device="cuda")
    flops = 2 * b * s * h * g * h
    bsh = b * s * h
    cases = {
        # xp (B, S, G H) in; y out; W, b_hh, the carry in and out
        f"rnn_{cell}_fwd": (lambda: kernel_fwd(xp, *states, w, bias),
                            lambda: rec._gated_loop(cell, xp, states[0], c0, w, bias, False),
                            bound(4 * (g * bsh + bsh + g * h * h + g * h + 2 * len(states) * b * h), flops),
                            lambda: lib(xp, lib_states), (b, s, h)),
        # dy, the saved gates (and y for gru) in; dxp (and dhp for gru) out; W; the carry's gradients
        f"rnn_{cell}_bwd": (bwd_fn, bwd_plain,
                            bound(4 * (bsh + rec.SAVED[cell] * bsh + (0 if lstm else bsh) + (1 if lstm else 2) * g * bsh
                                       + g * h * h + 3 * len(states) * b * h), flops),
                            lib_train, (b, s, h)),
    }
    for lanes in (64, 1):
        xs, st, _, _, _, _ = gated_case(cell, lanes, 1, h, gen, w, bias)
        cases[f"rnn_{cell}_fwd_{lanes}_lane{'s' if lanes > 1 else ''}"] = (
            lambda xs=xs, st=st: kernel_fwd(xs, *st, w, bias),
            lambda xs=xs, st=st: rec._gated_loop(cell, xs, st[0], st[1] if lstm else None, w, bias, False),
            bound(4 * (g * h * h + g * h + lanes * (g * h + h) + 2 * len(st) * lanes * h), 2 * lanes * h * g * h),
            lambda xs=xs, st=st: lib(xs, tuple(t[None] for t in st) if lstm else st[0][None]), (lanes, 1, h))
    out = {}
    for name, (kernel_fn, plain_fn, (bound_ms, bound_by), library_fn, shape) in cases.items():
        ms_ = [event_ms(plain_fn, 5), event_ms(kernel_fn, 10), event_ms(kernel_fn, 10), event_ms(plain_fn, 5)]
        out[name] = {
            "ms": min(ms_[1], ms_[2]), "plain_ms": min(ms_[0], ms_[3]), "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": event_ms(library_fn, 5), "call_ms": call_ms(kernel_fn, 10),
            "plain_call_ms": call_ms(plain_fn, 5), "timed_by": "CUDA events", "shape": list(shape),
        }
    fwd_row, bwd_row = out[f"rnn_{cell}_fwd"], out[f"rnn_{cell}_bwd"]
    fwd_row["library_input_projection_ms"] = event_ms(lambda: xp.reshape(-1, g * h) @ eye, 5)
    fwd_row["library_recurrence_ms"] = fwd_row["library_ms"] - fwd_row["library_input_projection_ms"]
    bwd_row["library_backward_ms"] = bwd_row["library_ms"] - fwd_row["library_ms"]
    fwd_row["library"] = bwd_row["library"] = (
        f"cuDNN nn.{'LSTM' if lstm else 'GRU'}, W_ih = I ({g * h} x {g * h}), fp32; the backward row forward + backward")
    ptxas = kernels.ptxas_report(kernels.build().with_suffix(".log").read_text())
    for name, t in out.items():
        backward = name.endswith("_bwd")
        plan = rec.gated_device_plan(cell, h, t["shape"][0], t["shape"][1], torch.cuda.current_device(), backward,
                                     False)
        kernel = "gated_bwd_kernel" if backward else "gated_step_kernel" if plan.launch == "step" else "gated_fwd_kernel"
        # the step kernel is a template on the cell, the sequence kernels also on the layout (the decoder's: none)
        fn = f"{kernel}<{'true' if lstm else 'false'}{'' if plan.launch == 'step' else ', false'}>"
        t["plan"] = {**dataclasses.asdict(plan), "blocks": plan.blocks(h)}
        t["registers"] = ptxas[fn]["registers"]
    return out


def drive_single_with_reset(cfg, model, obs, lang, seed, reset_at):
    """HulcPolicy over ``obs``, reset at step 0 and at ``reset_at``;
    (actions, pre-step states, post-step plans)."""
    from hulc_tpu_torch.evaluation.policy import HulcPolicy

    policy = HulcPolicy(cfg, model, seed=seed)
    actions, states, plans = [], [], []
    for t, o in enumerate(obs):
        if t in (0, reset_at):
            policy.reset()
        states.append(policy._state)
        actions.append(policy.step(o, lang))
        plans.append(policy._state.plan[0].cpu().numpy())
    return np.stack(actions), states, np.stack(plans)


def plain_single_with_reset(cfg, plain_model, obs, lang, seed, kern_states, reset_at):
    """The single-lane steps through the plain model from the kernel path's
    states, the resets at the same steps; (actions, post-step plans)."""
    from hulc_tpu_torch.evaluation.policy import HulcPolicy

    policy = HulcPolicy(cfg, plain_model, seed=seed)
    actions, plans = [], []
    for t, o in enumerate(obs):
        if t in (0, reset_at):
            policy.reset()
        policy._state = kern_states[t]
        actions.append(policy.step(o, lang))
        plans.append(policy._state.plan[0].cpu().numpy())
    return np.stack(actions), np.stack(plans)


def run_gated_cell(cell, seed, lanes, hulc_step_ms, card):
    """Phase 16 for one cell: ``hulc`` with ``action_decoder.rnn_cell=cell``
    at full width. Returns (summary, {kernel symbol: launches on the main
    path}, {row: max abs err}, {row: timing})."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.models import make_model
    from hulc_tpu_torch.ops.recurrence import GATES
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ, synthetic_fused_batch
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    cfg = gated_config(cell)
    ad = cfg.action_decoder
    model = make_model(cfg, "cuda", seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    rnn_params = sum(p.numel() for p in model.action_decoder.rnn.parameters())
    relu_rnn = ad.hidden_size * (model.action_decoder.rnn.weight_ih_l0.shape[1] + 3 * ad.hidden_size + 4)
    if rnn_params != GATES[cell] * relu_rnn or n_params != HULC_PARAMS + (GATES[cell] - 1) * relu_rnn:
        fail(f"the {cell} model has {n_params} parameters ({rnn_params} in its decoder RNN), expected "
             f"{HULC_PARAMS + (GATES[cell] - 1) * relu_rnn} ({GATES[cell]} x the relu RNN's {relu_rnn})")
    fwd_sym, bwd_sym = GATED_SYMBOLS[cell]
    print(f"[gated] hulc with action_decoder.rnn_cell={cell} (apply_overrides), {n_params} parameters, "
          f"{rnn_params} in the decoder RNN ({GATES[cell]} x the relu RNN's), random init from seed {seed}")

    # 1. the kernels against their plain versions, and their times
    errs = check_gated(cell, model, seed)
    timing = time_gated(cell, model, seed)
    for name, t in timing.items():
        plan = t["plan"]
        print(f"[gated] {name} at {tuple(t['shape'])}: kernel {t['ms']:.6f} ms, plain {t['plain_ms']:.6f} ms, cuDNN "
              f"{t['library_ms']:.6f} ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']}), "
              f"{100 * t['bound_ms'] / t['ms']:.1f}% of the bound; per call with the host's launch cost "
              f"{t['call_ms']:.5f} ms; {plan['launch']} launch, {plan['blocks']} blocks in clusters of "
              f"{plan['cluster']}, {plan['cols']} columns a cluster, k-slice {plan['k_slice']}, {plan['stages']} "
              f"stages, {plan['smem_bytes']} B shared memory, {t['registers']} registers a thread (CUDA events, {card})")
    fwd_row, bwd_row = timing[f"rnn_{cell}_fwd"], timing[f"rnn_{cell}_bwd"]
    print(f"[gated] cuDNN's own input projection (W_ih = I) {fwd_row['library_input_projection_ms']:.6f} ms of its "
          f"forward, its recurrence without it {fwd_row['library_recurrence_ms']:.6f} ms; its backward alone "
          f"((forward + backward) - forward) {bwd_row['library_backward_ms']:.6f} ms ({card})")

    # 2. the main path: train steps, a val step, the policies
    rng = np.random.default_rng(seed + 79)
    batch = synthetic_fused_batch(cfg, BATCH_PER_MOD, SEQ, seed, "cuda")
    val_batch = split_fused(batch)
    lang = rng.normal(size=cfg.lang_dim).astype(np.float32)
    single_obs = make_obs(rng, cfg, GATED_SINGLE_STEPS)
    langs = rng.normal(size=(lanes, cfg.lang_dim)).astype(np.float32)
    batched_obs = [make_obs(rng, cfg, lanes) for _ in range(GATED_LOCKSTEP_STEPS)]
    trainer = Trainer(cfg, TrainerConfig(seed=seed), "cuda")
    trainer.model.load_state_dict(model.state_dict())
    trainer.init_state(1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    step_losses, host, events = drive_training(trainer, batch, cfg.loss.kl_beta, GATED_TRAIN_STEPS)
    per_step = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainer.model.eval()
    with torch.no_grad():
        val = trainer.val_step(val_batch, cfg.loss.kl_beta, generator=torch.Generator(device="cuda").manual_seed(seed))
    trainer.model.train()
    torch.cuda.synchronize()
    val_launches = {k: n - per_step[k] for k, n in launch_counts().items()}
    single_actions, single_states, k_plans = drive_single_with_reset(cfg, model, single_obs, lang, seed, GATED_RESET_AT)
    batched_actions, batched_states = drive_batched(cfg, model, batched_obs, langs, seed)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"[gated main path] {cell}: launches {launches}")
    want = {fwd_sym: ad.num_layers, bwd_sym: ad.num_layers, "hulc_rnn_relu_fwd": 0, "hulc_rnn_relu_bwd": 0}
    if any(per_step[k] != n * GATED_TRAIN_STEPS for k, n in want.items()):
        fail(f"{GATED_TRAIN_STEPS} {cell} train steps launched {({k: per_step[k] for k in want})}, not "
             f"{({k: n * GATED_TRAIN_STEPS for k, n in want.items()})}: each layer's forward and dh chain once a step")
    # a val step decodes two windows (the proposal's and the recognition's plan) a modality
    if val_launches[fwd_sym] != 2 * 2 * ad.num_layers or val_launches[bwd_sym]:
        fail(f"the {cell} val step launched {val_launches[fwd_sym]} forwards and {val_launches[bwd_sym]} dh chains, "
             f"not {4 * ad.num_layers} and 0")
    acts = launches[fwd_sym] - per_step[fwd_sym] - val_launches[fwd_sym]
    if acts != ad.num_layers * (GATED_SINGLE_STEPS + GATED_LOCKSTEP_STEPS) or launches["hulc_rnn_relu_fwd"]:
        fail(f"the {cell} policy steps launched its forward {acts} times, not "
             f"{ad.num_layers * (GATED_SINGLE_STEPS + GATED_LOCKSTEP_STEPS)} (one a layer a step), and the relu "
             f"cell's {launches['hulc_rnn_relu_fwd']} times")
    if not all(launches[k] > 0 for k in GATED_SYMBOLS[cell]):
        fail(f"a kernel of the {cell} path was never launched: {launches}")
    for i, losses in enumerate(step_losses):
        if not all(np.isfinite(v) for v in losses.values()):
            fail(f"{cell} train step {i}: a loss is not finite: {losses}")
    if not all(np.isfinite(float(v)) for v in val.values()):
        fail(f"{cell} val step: a metric is not finite: {val}")
    check_actions(f"{cell} single lane", single_actions, 1)
    check_actions(f"{cell} batched", batched_actions, lanes)
    print(f"[gated main path] {cell}: " + "; ".join(
        f"step {i}: total {l['total_loss']:.5f} action {l['action_loss']:.5f} kl {l['kl_loss']:.6f} "
        f"grad_norm {l['grad_norm']:.5f}" for i, l in enumerate(step_losses)))
    step_ms, event_ms_ = statistics.median(host[2:]), statistics.median(events[2:])
    print(f"[timing] {cell} train step (2B={2 * BATCH_PER_MOD}, S={SEQ}, after 2 warm-ups): host clock {step_ms:.4f} "
          f"ms, CUDA events {event_ms_:.4f} ms, {2 * BATCH_PER_MOD / step_ms * 1e3:.2f} seq/s (hulc's relu decoder "
          f"{hulc_step_ms:.4f} ms in this run, phase 8); all steps host {[round(t, 4) for t in host]} ms; peak memory "
          f"{peak_gb:.2f} GB ({card})")
    del trainer

    # 3. the main path against the plain path
    train_check = compare_train_plain(cfg, model, batch, seed, label=f"{cell} train plain path")
    val_trainer = Trainer(cfg, TrainerConfig(seed=seed), "cuda")
    val_trainer.model.load_state_dict(model.state_dict())
    val_check = compare_val_plain(cfg, val_trainer, seed, val_batch, label=cell)
    del val_trainer, batch, val_batch
    plain_model = make_model(cfg, "cuda", seed=seed, use_kernels=False)
    plain_model.load_state_dict(model.state_dict())
    p_actions, p_plans = plain_single_with_reset(cfg, plain_model, single_obs, lang, seed, single_states, GATED_RESET_AT)
    replanned = np.array([t in (0, GATED_RESET_AT) for t in range(GATED_SINGLE_STEPS)])
    single_err = compare_plain(f"{cell} single lane, across a replan and a reset", single_actions, p_actions, k_plans,
                               p_plans, replanned, cfg)
    masks = [replan_mask(t, lanes, cfg.replan_freq) for t in range(GATED_LOCKSTEP_STEPS)]
    p_actions, p_plans = plain_batched(
        cfg, plain_model, list(zip(batched_obs, [langs] * GATED_LOCKSTEP_STEPS, batched_states, masks)), seed)
    k_plans = np.stack([s[0].cpu().numpy() for s in batched_states[1:]])
    batched_err = compare_plain(f"{cell} batched, {lanes} lanes, replans on some lanes", batched_actions, p_actions,
                                k_plans, p_plans, np.stack(masks), cfg)
    del plain_model

    # 4. lstm: the serving export at --lanes lanes, served in a process without model code
    export, served_launches = None, collections.Counter()
    if cell == "lstm":
        serving = tuple(k if k != "hulc_rnn_relu_fwd" else fwd_sym for k in SERVING_KERNELS)
        export, served_launches = run_serving_export({cell: (cfg, model, serving)}, seed, lanes, single_obs, lang,
                                                     batched_obs, langs, card, with_debug=False)
        launches = {k: n + served_launches.get(k, 0) for k, n in launches.items()}
    del model
    torch.cuda.empty_cache()
    summary = {
        "parameters": n_params, "decoder_rnn_parameters": rnn_params,
        "train_step": {"host_ms": step_ms, "event_ms": event_ms_, "steps_host_ms": host,
                       "seq_per_s": 2 * BATCH_PER_MOD / step_ms * 1e3, "peak_memory_gb": peak_gb,
                       "hulc_host_ms": hulc_step_ms, "plain_path": train_check},
        "val_step": {**val_check, "launches": {k: val_launches[k] for k in GATED_SYMBOLS[cell]}},
        "policy_plain_max_abs_err": {"1": single_err, str(lanes): batched_err},
        "serving_export": export, "phase_s": time.perf_counter() - t0, "card": card,
    }
    print(f"[gated] {cell} done in {summary['phase_s']:.1f} s")
    return summary, launches, errs, timing


def run_gated(seed, lanes, hulc_step_ms, card):
    """Phase 16: both gated cells. Returns (summary, {kernel symbol:
    launches}, {row: max abs err}, {row: timing})."""
    summary, launches, errs, timing = {}, collections.Counter(), {}, {}
    for cell in GATED_CELLS:
        s, n, e, t = run_gated_cell(cell, seed, lanes, hulc_step_ms, card)
        summary[cell] = s
        launches.update(n)
        errs.update(e)
        timing.update(t)
    return summary, launches, errs, timing


# --------------------------------------------------------------------------
# phase 17: hulc in bf16 (compute_dtype=bfloat16) at full width
# --------------------------------------------------------------------------

# the bf16 instances (B.14) of the eval preprocess, the shift, SpatialSoftmax forward and backward
BF16_SYMBOLS = ("hulc_preprocess_rgb_bf16", "hulc_preprocess_rgb_shift_bf16", "hulc_spatial_softmax_bf16",
                "hulc_spatial_softmax_bwd_bf16")
# the fp32 instances they take the place of, which a bf16 step and val step must not launch
BF16_REPLACES = {"hulc_preprocess_rgb_shift": "hulc_preprocess_rgb_shift_bf16",
                 "hulc_spatial_softmax": "hulc_spatial_softmax_bf16",
                 "hulc_spatial_softmax_bwd": "hulc_spatial_softmax_bwd_bf16"}
# a bf16 policy preprocesses to fp32 (as JAX's policies do) and reads a bf16 map
BF16_SERVING = ("hulc_preprocess_rgb", "hulc_spatial_softmax_bf16", "hulc_logistic_mixture_sample", "hulc_rnn_relu_fwd")
BF16_SINGLE_STEPS, BF16_RESET_AT = 4, 2  # single lane: replans at 0 and, after a reset, at 2
BF16_LOCKSTEP_STEPS = 3
BF16_DX_REL = 1e-3  # B.2' bf16 dx against the plain version, relative L2 (a few entries one bf16 ulp apart)
BF16_ULP = 2.0**-7  # bf16's spacing relative to a value's power of two
# the val metrics' limits: the larger of VAL_REL and NOISE_FACTOR x the plain path's largest
# change when B.2's own share of keypoints (those its kernel rounds to another bf16 value at
# the next layer's input) moves one bf16 ulp, over these random patterns
BF16_VAL_PATTERNS = 4


def bf16_config():
    """``hulc`` with compute_dtype=bfloat16, set as a user sets it (apply_overrides)."""
    from hulc_tpu_torch.config import apply_overrides, get_config

    return apply_overrides(get_config("hulc"), ["compute_dtype=bfloat16"])


def check_bf16_dx(got, want, where):
    """B.2' bf16 dx against the plain version's: every entry within one bf16
    ulp of the larger magnitude plus the fp32 instance's atol (an entry whose
    fp32 sum cancels), and BF16_DX_REL relative L2; returns the largest abs err."""
    g, w = got.double(), want.double()
    limit = BF16_ULP * torch.maximum(g.abs(), w.abs()) + SS_BWD_ATOL
    if not (bool(((g - w).abs() <= limit).all()) and rel_l2(got, want) <= BF16_DX_REL):
        fail(f"SpatialSoftmax backward bf16 kernel at {where}: {int(((g - w).abs() > limit).sum())} entries beyond "
             f"one bf16 ulp, relative L2 {rel_l2(got, want)} (limit {BF16_DX_REL})")
    return max_abs(got, want)


def check_bf16_kernels(batch, conv_map, gen):
    """The four bf16 instances against their plain versions, and against
    the fp32 instances on the same values (the bf16 ones convert to fp32 in
    registers and compute in the fp32 instances' order, then round once):
    B.1 at the val window shape and B.1' at the step's, bit-equal to both;
    B.2 on the step's bf16 map (2048, 64, 21, 21) and on its first 64 and 1
    rows within SS_FWD_RTOL / SS_FWD_ATOL of the plain version and
    bit-equal to the fp32 instance, at T = 1 and a learnable T = 0.7; B.2'
    and B.2'' with ``check_bf16_dx``, dT within SS_DTEMP_RTOL, dx bit-equal
    to the fp32 instance's rounded once and dT equal. Returns ({row: max
    abs err}, the step's shifts)."""
    from hulc_tpu_torch.ops.image_ops import (
        draw_shifts, preprocess_rgb_seq, preprocess_rgb_seq_plain, preprocess_rgb_seq_shift,
        preprocess_rgb_seq_shift_plain,
    )
    from hulc_tpu_torch.ops.spatial_softmax import (
        spatial_softmax_bwd, spatial_softmax_bwd_plain, spatial_softmax_fwd_kernel, spatial_softmax_plain,
    )

    bf16, fused = torch.bfloat16, batch["fused"]
    b = fused.actions.shape[0] // 2
    pe = bf16_config().perceptual_encoder
    for cam in ("rgb_static", "rgb_gripper"):
        imgs = getattr(fused, cam)[:b]  # the val window shape: one modality
        got = preprocess_rgb_seq(imgs, out_dtype=bf16)
        if not (got.dtype == bf16 and torch.equal(got, preprocess_rgb_seq_plain(imgs, out_dtype=bf16))
                and torch.equal(got, preprocess_rgb_seq(imgs).to(bf16))):
            fail(f"bf16 eval preprocess kernel at the window shape {tuple(imgs.shape)} is not bit-equal to the plain "
                 f"version and to the fp32 instance rounded")
    n, s = fused.actions.shape[:2]
    shifts = {cam: draw_shifts(n * s, getattr(pe, cam).shift_pad, gen, "cuda") for cam in ("rgb_static", "rgb_gripper")}
    for cam, sh in shifts.items():
        imgs, pad = getattr(fused, cam), getattr(pe, cam).shift_pad
        got = preprocess_rgb_seq_shift(imgs, sh, pad, out_dtype=bf16)
        if not (torch.equal(got, preprocess_rgb_seq_shift_plain(imgs, sh, pad, out_dtype=bf16))
                and torch.equal(got, preprocess_rgb_seq_shift(imgs, sh, pad).to(bf16))):
            fail(f"bf16 shift kernel at {tuple(imgs.shape)} is not bit-equal to the plain version and to the fp32 "
                 f"instance rounded")
    errs = {"preprocess_rgb_bf16": 0.0, "preprocess_rgb_shift_bf16": 0.0, "spatial_softmax_bf16": 0.0}
    for rows in (conv_map.shape[0], 64, 1):
        x = conv_map[:rows]
        for temp in (1.0, torch.tensor([0.7], device="cuda")):
            got, want = spatial_softmax_fwd_kernel(x, temp), spatial_softmax_plain(x, temp)
            if not torch.allclose(got, want, rtol=SS_FWD_RTOL, atol=SS_FWD_ATOL):
                fail(f"bf16 SpatialSoftmax kernel at {tuple(x.shape)}, T = {float(temp)}: max abs err "
                     f"{max_abs(got, want)}")
            if not torch.equal(got, spatial_softmax_fwd_kernel(x.float(), temp)):
                fail(f"bf16 SpatialSoftmax kernel at {tuple(x.shape)} is not bit-equal to the fp32 instance on its "
                     f"values")
            errs["spatial_softmax_bf16"] = max(errs["spatial_softmax_bf16"], max_abs(got, want))
            if rows == conv_map.shape[0] and not isinstance(temp, torch.Tensor):
                # the share of keypoints the kernel rounds to another bf16 value than the plain version
                errs["spatial_softmax_bf16_flips"] = float((got.to(bf16) != want.to(bf16)).float().mean())
    grad = torch.randn(conv_map.shape[0], 2 * conv_map.shape[1], generator=gen, device="cuda")
    errs["spatial_softmax_bwd_bf16"], dt_err = 0.0, 0.0
    for temp in (1.0, torch.tensor([0.7], device="cuda")):
        dx, dt = spatial_softmax_bwd(conv_map, grad, temp)
        p_dx, p_dt = spatial_softmax_bwd_plain(conv_map, grad, temp)
        where = f"the step's shape, T = {float(temp)}"
        errs["spatial_softmax_bwd_bf16"] = max(errs["spatial_softmax_bwd_bf16"], check_bf16_dx(dx, p_dx, where))
        f_dx, f_dt = spatial_softmax_bwd(conv_map.float(), grad, temp)
        if not torch.equal(dx, f_dx.to(bf16)) or (dt is not None and not torch.equal(dt, f_dt)):
            fail(f"bf16 SpatialSoftmax backward at {where} is not the fp32 instance's dx rounded once (and its dT)")
        if dt is not None:
            dt_err = float((dt - p_dt).abs() / p_dt.abs())
            if not dt_err <= SS_DTEMP_RTOL:
                fail(f"bf16 SpatialSoftmax temperature gradient: {float(dt)} vs {float(p_dt)} (relative {dt_err})")
    errs["spatial_softmax_bwd_bf16_dtemp_rel"] = dt_err
    print(f"[bf16 kernels] B.1 at the window shapes and B.1' at the step's bit-equal to their plain versions and to "
          f"the fp32 instances rounded; B.2 at (2048/64/1, 64, 21, 21) bf16 within max abs "
          f"{errs['spatial_softmax_bf16']:.3g} of the plain version ({errs['spatial_softmax_bf16_flips']:.3g} of them "
          f"round to another bf16 value at the step's shape) and bit-equal to the fp32 instance on the same values; B.2'/B.2'' dx within one bf16 ulp (max abs {errs['spatial_softmax_bwd_bf16']:.3g}) of the plain "
          f"version and bit-equal to the fp32 instance's rounded once, dT relative {dt_err:.3g}")
    return errs, shifts


def time_bf16_kernels(batch, conv_map, shifts, card):
    """Device ms of each bf16 instance, of the fp32 instance on the same
    shapes and values and of the plain version, with the bound (bytes: u8
    in and bf16 out; the bf16 map in, fp32 keypoints out; map, dx and the
    keypoints' gradient). By CUDA events (``kernel_times.event_ms``): this
    late in the run the profiler can drop a short window whole."""
    from hulc_tpu_torch.evaluation.kernel_times import event_ms
    from hulc_tpu_torch.ops.image_ops import (
        preprocess_rgb_seq, preprocess_rgb_seq_plain, preprocess_rgb_seq_shift, preprocess_rgb_seq_shift_plain,
    )
    from hulc_tpu_torch.ops.spatial_softmax import (
        spatial_softmax_bwd, spatial_softmax_fwd_kernel, spatial_softmax_plain,
    )

    bf16, fused = torch.bfloat16, batch["fused"]
    b = fused.actions.shape[0] // 2
    pe = bf16_config().perceptual_encoder
    pads = {cam: getattr(pe, cam).shift_pad for cam in shifts}
    x32, grad = conv_map.float(), torch.randn(conv_map.shape[0], 2 * conv_map.shape[1], device="cuda")
    n_map, n_out = conv_map.numel(), conv_map.shape[0] * 2 * conv_map.shape[1]
    x32_plain = x32.clone().requires_grad_()
    ss_out = spatial_softmax_plain(x32_plain, 1.0)
    x16_plain = conv_map.clone().requires_grad_()
    ss_out16 = spatial_softmax_plain(x16_plain, 1.0)
    n_px = sum(getattr(fused, cam).numel() for cam in shifts)
    n_frames = 2 * fused.actions.shape[0] * fused.actions.shape[1]

    def shift(out_dtype, plain=False):
        fn = preprocess_rgb_seq_shift_plain if plain else preprocess_rgb_seq_shift
        return lambda: [fn(getattr(fused, cam), sh, pads[cam], out_dtype=out_dtype) for cam, sh in shifts.items()]

    cases = {
        # per camera at the val window shape: u8 in, bf16 out
        **{f"preprocess_rgb_bf16{'' if cam == 'rgb_static' else '_gripper'}_window": (
            lambda imgs=getattr(fused, cam)[:b]: preprocess_rgb_seq(imgs, out_dtype=bf16),
            lambda imgs=getattr(fused, cam)[:b]: preprocess_rgb_seq(imgs),
            lambda imgs=getattr(fused, cam)[:b]: preprocess_rgb_seq_plain(imgs, out_dtype=bf16),
            bound(3 * getattr(fused, cam)[:b].numel(), 0), list(getattr(fused, cam)[:b].shape))
            for cam in ("rgb_static", "rgb_gripper")},
        # both cameras at the step's shape: u8 in, bf16 out, the shifts
        "preprocess_rgb_shift_bf16": (shift(bf16), shift(torch.float32), shift(bf16, plain=True),
                                      bound(3 * n_px + 8 * n_frames, 3 * n_px), None),
        # the map in (bf16), the keypoints out (fp32); ~9 flops a logit
        **{f"spatial_softmax_bf16{'' if rows == 2048 else f'_{rows}'}": (
            lambda x=conv_map[:rows]: spatial_softmax_fwd_kernel(x, 1.0),
            lambda x=x32[:rows]: spatial_softmax_fwd_kernel(x, 1.0),
            lambda x=conv_map[:rows]: spatial_softmax_plain(x, 1.0),
            bound(2 * conv_map[:rows].numel() + 4 * rows * 128, 9 * conv_map[:rows].numel()),
            list(conv_map[:rows].shape)) for rows in (2048, 64, 1)},
        # the map and dx (bf16), the keypoints' gradient (fp32); ~12 flops an entry
        "spatial_softmax_bwd_bf16": (lambda: spatial_softmax_bwd(conv_map, grad, 1.0),
                                     lambda: spatial_softmax_bwd(x32, grad, 1.0),
                                     lambda: torch.autograd.grad(ss_out16, x16_plain, grad, retain_graph=True),
                                     bound(4 * n_map + 4 * n_out, 12 * n_map), list(conv_map.shape)),
        "spatial_softmax_bwd_bf16_learnable_t": (
            lambda: spatial_softmax_bwd(conv_map, grad, torch.tensor([0.7], device="cuda")),
            lambda: spatial_softmax_bwd(x32, grad, torch.tensor([0.7], device="cuda")),
            lambda: torch.autograd.grad(ss_out16, x16_plain, grad, retain_graph=True),
            bound(4 * n_map + 4 * n_out + 8, 14 * n_map), list(conv_map.shape)),
    }
    out = {}
    for name, (kernel_fn, fp32_fn, plain_fn, (bound_ms, bound_by), shape) in cases.items():
        iters = 20
        ms_ = [event_ms(fp32_fn, iters), event_ms(kernel_fn, iters), event_ms(kernel_fn, iters), event_ms(fp32_fn, iters)]
        out[name] = {
            "ms": min(ms_[1], ms_[2]), "fp32_ms": min(ms_[0], ms_[3]), "plain_ms": event_ms(plain_fn, 5),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "call_ms": call_ms(kernel_fn, iters), "plain_call_ms": call_ms(plain_fn, 5),
        }
        if shape is not None:
            out[name]["shape"] = shape
        t = out[name]
        print(f"[bf16 timing] {name}{'' if shape is None else f' at {tuple(shape)}'}: bf16 kernel {t['ms']:.6f} ms, "
              f"fp32 instance {t['fp32_ms']:.6f} ms, plain {t['plain_ms']:.6f} ms, bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}), {100 * t['bound_ms'] / t['ms']:.1f}% of the bound ({card})")
    del ss_out, ss_out16
    return out


def action_change(cfg, moved, base):
    """The largest change of a continuous action dimension between two plain
    runs, each (actions, post-step plans), over the (step, lane) pairs whose
    plan picks agree: the discrete gripper's pick is held equal and a plan
    pick that flips is a tie (``compare_plain``)."""
    (a1, p1), (a0, p0) = moved, base
    d = cfg.distribution
    same = np.ones(a0.shape[:-1], bool)
    if d.kind == "discrete":
        grid = (d.category_size, d.class_size)
        same = (p1.reshape(p1.shape[:-1] + grid).argmax(-1) == p0.reshape(p0.shape[:-1] + grid).argmax(-1)).all(-1)
    cont = slice(None, -1 if cfg.action_decoder.discrete_gripper else None)
    diff = np.abs(a1[..., cont] - a0[..., cont])[same]
    return float(diff.max()) if diff.size else 0.0


def plain_policies(cfg, plain_model, single_obs, lang, seed, single_states, batched, bf16_share):
    """The plain path's actions and plans (single lane and lockstep, each
    step from the kernel path's state), with the decoder recurrence
    kernel's own share of bf16 rounding flips on each (``recurrence_flips``),
    and the single lane's sensitivity: its largest action change
    (``action_change``) under ``ulp_noise`` of the keypoints (``bf16_share``,
    B.2's share; the decoder reads the gripper camera's features only, so
    the keypoints reach an action through a replanned plan alone) and
    ``recurrence_noise`` at the recurrence's single-lane share, over
    ULP_PATTERNS patterns. Returns (single, lockstep, {lanes: the flip
    counts}, sensitivity)."""
    from hulc_tpu_torch.models import vision

    cell, num_layers = cfg.action_decoder.rnn_cell, cfg.action_decoder.num_layers
    batched_obs, langs, batched_states, masks = batched
    steps = list(zip(batched_obs, [langs] * BF16_LOCKSTEP_STEPS, batched_states, masks))
    with recurrence_flips(cell, num_layers) as single_flips:
        single = plain_single_with_reset(cfg, plain_model, single_obs, lang, seed, single_states, BF16_RESET_AT)
    with recurrence_flips(cell, num_layers) as batched_flips:
        lockstep = plain_batched(cfg, plain_model, steps, seed)
    flips = {1: single_flips, len(langs): batched_flips}
    sens = 0.0
    for i in range(ULP_PATTERNS):
        with ulp_noise(vision, "spatial_softmax_plain", seed + 31 + 2 * i, bf16_share), \
                recurrence_noise(cell, num_layers, seed + 32 + 2 * i, single_flips["flipped"] / single_flips["outputs"]):
            moved = plain_single_with_reset(cfg, plain_model, single_obs, lang, seed, single_states, BF16_RESET_AT)
        sens = max(sens, action_change(cfg, moved, single))
    return single, lockstep, flips, sens


def kernel_recurrence_in_plain(cfg, plain_model, single_obs, lang, seed, single_states):
    """The plain single-lane steps with the decoder recurrence's kernel in
    place of its plain loop (everything else plain): how much of the
    kernel path's difference from the plain path the recurrence makes."""
    from hulc_tpu_torch.models.layers import RECURRENCES

    kernel = RECURRENCES[cfg.action_decoder.rnn_cell][0]

    def wrap(plain):
        def through_kernel(x_proj, *rest):
            *state, w_hh, b_hh = rest
            return kernel(x_proj, *(s.contiguous() for s in state), w_hh, b_hh)[0]
        return through_kernel

    with plain_recurrence(cfg.action_decoder.rnn_cell, wrap):
        return plain_single_with_reset(cfg, plain_model, single_obs, lang, seed, single_states, BF16_RESET_AT)


def run_bf16(seed, lanes, train_steps, hulc_step_ms, hulc_peak_gb, card):
    """Phase 17: ``hulc`` with compute_dtype=bfloat16 at full width.
    Returns (summary, {kernel symbol: launches on the main path}, {row: max
    abs err}, {row: timing})."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.models import make_model
    from hulc_tpu_torch.training.preprocess import preprocess_batch
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ, synthetic_fused_batch
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    cfg = bf16_config()
    model = make_model(cfg, "cuda", seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != HULC_PARAMS or {p.dtype for p in model.parameters()} != {torch.float32}:
        fail(f"the bf16 hulc model has {n_params} parameters of {({p.dtype for p in model.parameters()})}, "
             f"expected {HULC_PARAMS} fp32")
    print(f"[bf16] hulc with compute_dtype=bfloat16 (apply_overrides), {n_params} fp32 parameters, random init from "
          f"seed {seed}")

    # 1. the bf16 instances against their plain versions and the fp32 instances, and their times
    batch = synthetic_fused_batch(cfg, BATCH_PER_MOD, SEQ, seed, "cuda")
    with torch.no_grad():
        prep = preprocess_batch(cfg, batch, train=False)["fused"]
        conv_map = model.perceptual_encoder.rgb_static_encoder.conv_model(prep.rgb_static.flatten(0, 1)).contiguous()
        del prep
    if conv_map.dtype != torch.bfloat16:
        fail(f"the bf16 model's static conv map is {conv_map.dtype}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 83)
    errs, shifts = check_bf16_kernels(batch, conv_map, gen)
    # the plain path's sensitivity noise: B.2's own share of keypoints whose bf16 rounding it moves
    bf16_share = errs.pop("spatial_softmax_bf16_flips")
    timing = time_bf16_kernels(batch, conv_map, shifts, card)
    del conv_map, shifts
    torch.cuda.empty_cache()

    # 2. the main path: train steps, a val step, the policies
    rng = np.random.default_rng(seed + 89)
    val_batch = split_fused(batch)
    lang = rng.normal(size=cfg.lang_dim).astype(np.float32)
    single_obs = make_obs(rng, cfg, BF16_SINGLE_STEPS)
    langs = rng.normal(size=(lanes, cfg.lang_dim)).astype(np.float32)
    batched_obs = [make_obs(rng, cfg, lanes) for _ in range(BF16_LOCKSTEP_STEPS)]
    trainer = Trainer(cfg, TrainerConfig(seed=seed), "cuda")
    trainer.model.load_state_dict(model.state_dict())
    trainer.init_state(1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    step_losses, host, events = drive_training(trainer, batch, cfg.loss.kl_beta, train_steps)
    per_step = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainer.model.eval()
    with torch.no_grad():
        val = trainer.val_step(val_batch, cfg.loss.kl_beta, generator=torch.Generator(device="cuda").manual_seed(seed))
    trainer.model.train()
    torch.cuda.synchronize()
    val_launches = {k: n - per_step[k] for k, n in launch_counts().items()}
    single_actions, single_states, k_plans = drive_single_with_reset(cfg, model, single_obs, lang, seed, BF16_RESET_AT)
    batched_actions, batched_states = drive_batched(cfg, model, batched_obs, langs, seed)
    torch.cuda.synchronize()
    launches = launch_counts()
    policy_launches = {k: n - per_step[k] - val_launches[k] for k, n in launches.items()}
    print(f"[bf16 main path] launches: train steps {({k: per_step[k] for k in BF16_SYMBOLS + tuple(BF16_REPLACES)})}, "
          f"val step {({k: val_launches[k] for k in BF16_SYMBOLS + ('hulc_preprocess_rgb',)})}, policy steps "
          f"{({k: policy_launches[k] for k in BF16_SERVING + ('hulc_spatial_softmax',)})}")
    want = {"hulc_preprocess_rgb_shift_bf16": 2, "hulc_spatial_softmax_bf16": 1, "hulc_spatial_softmax_bwd_bf16": 1,
            **dict.fromkeys(BF16_REPLACES, 0)}
    if any(per_step[k] != n * train_steps for k, n in want.items()):
        fail(f"{train_steps} bf16 train steps launched {({k: per_step[k] for k in want})}, not "
             f"{({k: n * train_steps for k, n in want.items()})}: the bf16 instances, never the fp32 ones")
    # a val step: B.1 for both cameras of both modalities, B.2 per modality, no fp32 preprocess
    if (val_launches["hulc_preprocess_rgb_bf16"], val_launches["hulc_spatial_softmax_bf16"],
            val_launches["hulc_preprocess_rgb"], val_launches["hulc_spatial_softmax"]) != (4, 2, 0, 0):
        fail(f"the bf16 val step launched {val_launches}, not B.1's bf16 instance 4 times and B.2's twice")
    if not all(policy_launches[k] > 0 for k in BF16_SERVING) or policy_launches["hulc_spatial_softmax"]:
        fail(f"the bf16 policy steps launched {policy_launches}: they must launch {BF16_SERVING} and not the fp32 "
             f"SpatialSoftmax")
    for i, losses in enumerate(step_losses):
        if not all(np.isfinite(v) for v in losses.values()):
            fail(f"bf16 train step {i}: a loss is not finite: {losses}")
    if not all(np.isfinite(float(v)) for v in val.values()):
        fail(f"bf16 val step: a metric is not finite: {val}")
    check_actions("bf16 single lane", single_actions, 1)
    check_actions("bf16 batched", batched_actions, lanes)
    print("[bf16 main path] " + "; ".join(
        f"step {i}: total {l['total_loss']:.5f} action {l['action_loss']:.5f} kl {l['kl_loss']:.6f} "
        f"clip {l['lang_clip_loss']:.5f} grad_norm {l['grad_norm']:.5f}" for i, l in enumerate(step_losses)))
    step_ms, event_ms_ = statistics.median(host[2:]), statistics.median(events[2:])
    print(f"[timing] bf16 train step (2B={2 * BATCH_PER_MOD}, S={SEQ}, median of {len(host) - 2} after 2 warm-ups): "
          f"host clock {step_ms:.4f} ms, CUDA events {event_ms_:.4f} ms, {2 * BATCH_PER_MOD / step_ms * 1e3:.2f} "
          f"seq/s; fp32 hulc {hulc_step_ms:.4f} ms in this run (phase 8), bf16 / fp32 {step_ms / hulc_step_ms:.4f}; all steps "
          f"host {[round(t, 4) for t in host]} ms; peak memory {peak_gb:.2f} GB (fp32 {hulc_peak_gb:.2f} GB) ({card})")
    del trainer

    # 3. the main path against the plain path
    train_check = compare_train_plain(cfg, model, batch, seed, label="bf16 train plain path", bf16_share=bf16_share)
    val_trainer = Trainer(cfg, TrainerConfig(seed=seed), "cuda")
    val_trainer.model.load_state_dict(model.state_dict())
    val_check = compare_val_plain(cfg, val_trainer, seed, val_batch, label="bf16", patterns=BF16_VAL_PATTERNS,
                                  bf16_share=bf16_share)
    del val_trainer, batch, val_batch
    torch.cuda.empty_cache()
    plain_model = make_model(cfg, "cuda", seed=seed, use_kernels=False)
    plain_model.load_state_dict(model.state_dict())
    masks = [replan_mask(t, lanes, cfg.replan_freq) for t in range(BF16_LOCKSTEP_STEPS)]
    (p_single, p_single_plans), (p_batched, p_batched_plans), flips, sens = plain_policies(
        cfg, plain_model, single_obs, lang, seed, single_states, (batched_obs, langs, batched_states, masks),
        bf16_share)
    shares = {n: c["flipped"] / c["outputs"] for n, c in flips.items()}
    # the single lane: the larger of ACTION_ATOL and NOISE_FACTOR x its sensitivity; the lockstep lanes: ACTION_ATOL
    single_limit = max(ACTION_ATOL, NOISE_FACTOR * sens)
    with_kernel = kernel_recurrence_in_plain(cfg, plain_model, single_obs, lang, seed, single_states)[0]
    kernel_rnn_err = float(np.abs(with_kernel - single_actions).max())
    print(f"[bf16] the decoder recurrence's kernel rounds "
          + ", ".join(f"{c['flipped']} of {c['outputs']} ({shares[n]:.3g})" for n, c in flips.items())
          + f" layer-0 outputs to another bf16 value than the plain loop at 1 and {lanes} lanes; the single lane's "
          f"limit is the larger of {ACTION_ATOL} and {NOISE_FACTOR} x its sensitivity {sens:.3g} (a {bf16_share:.3g} "
          f"share of the keypoints, B.2's, and a {shares[1]:.3g} share of those outputs, the recurrence's, one bf16 "
          f"ulp away, over {ULP_PATTERNS} patterns): {single_limit:.3g}; {lanes} lanes {ACTION_ATOL}; the plain path "
          f"with the recurrence's kernel in place of its loop is within {kernel_rnn_err:.3g} of the kernel path's "
          f"single-lane actions")
    replanned = np.array([t in (0, BF16_RESET_AT) for t in range(BF16_SINGLE_STEPS)])
    single_err = compare_plain("bf16 single lane, across a replan and a reset", single_actions, p_single, k_plans,
                               p_single_plans, replanned, cfg, atol=single_limit)
    k_batched_plans = np.stack([s[0].cpu().numpy() for s in batched_states[1:]])
    batched_err = compare_plain(f"bf16 batched, {lanes} lanes, replans on some lanes", batched_actions, p_batched,
                                k_batched_plans, p_batched_plans, np.stack(masks), cfg)
    del plain_model

    # 4. the serving export at --lanes lanes, served in a process without model code
    export, served_launches = run_serving_export({"bf16": (cfg, model, BF16_SERVING)}, seed, lanes, single_obs, lang,
                                                 batched_obs, langs, card, with_debug=False)
    launches = {k: n + served_launches.get(k, 0) for k, n in launches.items()}
    if not all(launches[k] > 0 for k in BF16_SYMBOLS):
        fail(f"a bf16 kernel was never launched on the bf16 main path: {launches}")
    del model
    torch.cuda.empty_cache()
    summary = {
        "parameters": n_params,
        "train_step": {"host_ms": step_ms, "event_ms": event_ms_, "steps_host_ms": host,
                       "seq_per_s": 2 * BATCH_PER_MOD / step_ms * 1e3, "peak_memory_gb": peak_gb,
                       "fp32_host_ms": hulc_step_ms, "fp32_peak_memory_gb": hulc_peak_gb,
                       "launches_per_step": {k: per_step[k] // train_steps for k in want}, "plain_path": train_check},
        "val_step": {**val_check, "launches": {k: val_launches[k] for k in BF16_SYMBOLS}},
        "policy_plain": {"max_abs_err": {"1": single_err, str(lanes): batched_err},
                         "recurrence_flip_share": {str(k): v for k, v in shares.items()},
                         "keypoint_flip_share": bf16_share, "ulp_sensitivity": {"1": sens},
                         "limit": {"1": single_limit, str(lanes): ACTION_ATOL},
                         "kernel_recurrence_in_plain_err": {"1": kernel_rnn_err}},
        "serving_export": export, "phase_s": time.perf_counter() - t0, "card": card,
    }
    print(f"[bf16] done in {summary['phase_s']:.1f} s")
    return summary, launches, errs, timing


# --------------------------------------------------------------------------
# phase 18: B.5' (the optimizer instances), the train and evaluate CLIs, the import
# --------------------------------------------------------------------------

OPTIMIZER_STEPS = 3  # steps each optimizer instance takes from one state, kernel and plain
# the instances of csrc/adam_lowp.cu's template: the optimizer class, the entry point, the
# moments, the bytes and operations a parameter (the update and g^2), the JAX line replaced
OPTIMIZER_INSTANCES = {
    "adam_lowp": ("AdamLowp", "hulc_adam_lowp", ("exp_avg", "exp_avg_sq"), 20, 14, "hulc_tpu/training/optimizers.py:24"),
    "adam_fp32": ("Adam", "hulc_adam_fp32", ("exp_avg", "exp_avg_sq"), 28, 14, "hulc_tpu/training/trainer.py:189"),
    "adamw": ("AdamW", "hulc_adamw", ("exp_avg", "exp_avg_sq"), 28, 16, "hulc_tpu/training/trainer.py:191"),
    "sgd": ("SGD", "hulc_sgd", ("momentum_buffer",), 20, 4, "hulc_tpu/training/trainer.py:193"),
}
# what the train CLI's steps launch (B.5 or a B.5' instance, by --optimizer and
# --adam-mv-dtype), and what the evaluate CLI's, the rollout's and validation's policy steps do
CLI_TRAIN_KERNELS = tuple(k for k in TRAIN_KERNELS if k != "hulc_adam_lowp") + tuple(
    v[1] for v in OPTIMIZER_INSTANCES.values())
CLI_EVAL_KERNELS = SERVING_KERNELS
# the kernels a profile window of train steps must name (csrc/ function names)
PROFILED_TRAIN_KERNELS = (
    "preprocess_rgb_shift_kernel", "spatial_softmax_kernel", "spatial_softmax_bwd_kernel", "mixture_nll_fwd_kernel",
    "mixture_nll_bwd_kernel", "plan_st_kl_fwd_kernel", "plan_st_kl_bwd_kernel", "rnn_fwd_kernel", "rnn_bwd_kernel",
    "adam_lowp_kernel", "grad_norm_finish_kernel",
)
PROFILE_RUNS = 2  # the profiler drops some launches of the short kernels: a window that misses one is run again
CLI_LANES, CLI_CHAINS, CLI_EP_LEN = 64, 64, 90  # the rollout's and the batched evaluations' sizes
SEQUENTIAL_CHAINS = 4
IMPORT_EXTRA_KEY = "perceptual_encoder.rgb_static_encoder.spatial_softmax.x_map"  # a buffer the port lacks
RESULT_KEYS = {"avg_seq_len", "chain_sr", "task_sr", "task_info"}  # JAX's results.json, per epoch


def optimizer_state(shapes, seed):
    """One state at the model's shapes: parameters 0.05 N(0, 1) and the
    gradients of OPTIMIZER_STEPS steps, 1e-3 N(0, 1), the second tensor
    without a gradient and every other element of the first zero."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = [0.05 * torch.randn(s, generator=gen, device="cuda") for s in shapes]
    steps = []
    for _ in range(OPTIMIZER_STEPS):
        grads = [1e-3 * torch.randn(s, generator=gen, device="cuda") for s in shapes]
        grads[1] = None
        grads[0].view(-1)[::2] = 0.0
        steps.append(grads)
    return base, steps


def check_optimizer_instances(shapes, seed):
    """Each instance of B.5's template (B.5, and B.5' for Adam, AdamW and
    SGD) through its optimizer class over OPTIMIZER_STEPS steps at the
    model's parameters, against the plain version from the same state:
    parameters and moments bit-equal, each step's norm within
    GRAD_NORM_RTOL of the plain ``global_norm``. Returns {name: (max abs
    err of parameters and moments, the norms' largest relative error)}."""
    from hulc_tpu_torch.training import optimizers

    base, steps = optimizer_state(shapes, seed)
    out = {}
    for name, (cls_name, symbol, moment_keys, *_) in OPTIMIZER_INSTANCES.items():
        sides = []
        for use_kernels in (True, False):
            params = [torch.nn.Parameter(b.clone()) for b in base]
            sides.append((params, getattr(optimizers, cls_name)(params, lr=2e-4, use_kernels=use_kernels)))
        (kparams, kopt), (pparams, popt) = sides
        norm_err = 0.0
        for grads in steps:
            for params in (kparams, pparams):
                for p, g in zip(params, grads):
                    p.grad = g
            knorm, pnorm = kopt.step(), popt.step()
            norm_err = max(norm_err, abs(float(knorm) - float(pnorm)) / float(pnorm))
        if not norm_err <= GRAD_NORM_RTOL:
            fail(f"{name}: the kernel's gradient norm is {norm_err:.3g} off the plain global_norm")
        for kp, pp in zip(kparams, pparams):
            for what, got, want in [("params", kp, pp)] + [(k, kopt.state[kp][k], popt.state[pp][k]) for k in moment_keys]:
                if not torch.equal(got, want):
                    fail(f"{name}: {what} of a {tuple(kp.shape)} tensor not bit-equal to the plain version after "
                         f"{OPTIMIZER_STEPS} steps (max abs err {max_abs(got, want):.3g})")
        out[name] = (0.0, norm_err)
        print(f"[optimizers] {name} ({symbol}): {OPTIMIZER_STEPS} steps over {sum(b.numel() for b in base)} "
              f"parameters in {len(base)} tensors (one without a gradient) bit-equal to the plain version in params "
              f"and {', '.join(moment_keys)}; norms within {norm_err:.3g} of the plain global_norm")
        del sides, kparams, pparams, kopt, popt
    return out


def time_optimizer_instances(shapes, seed, card):
    """Ms per call by CUDA events (``kernel_times.event_ms``) of each
    instance's update and finish, of its plain version (the eager norm,
    then each tensor's update; it waits for the device at each tensor's
    scalar uploads, so its time is the host's: 2 calls a window) and of the
    library yardstick (fused ``torch.optim.Adam`` / ``AdamW``,
    ``SGD(foreach=True)``, each with ``get_total_norm``; never on the path),
    beside the bound: the bytes a parameter moves (20 for bf16 Adam and
    SGD, 28 for fp32 Adam and AdamW) and the partials, or the operations.
    Events, not the profiler: in a long process its windows drop these
    launches (PERF.md §7)."""
    from hulc_tpu_torch.evaluation.kernel_times import event_ms
    from hulc_tpu_torch.training import optimizers as o

    base, steps = optimizer_state(shapes, seed)
    grads = steps[0]
    n_params = sum(b.numel() for b in base)
    c1, c2 = o.bias_corrections(0.9, 0.999, 1)
    out = {}
    for name, (_, symbol, moment_keys, nbytes, nops, _) in OPTIMIZER_INSTANCES.items():
        dtype = torch.bfloat16 if name == "adam_lowp" else torch.float32
        ps = [b.clone() for b in base]
        moments = [[torch.zeros_like(b, dtype=dtype) for b in base] for _ in moment_keys]
        table = o.PointerTable()
        wd = o.ADAMW_WEIGHT_DECAY if name == "adamw" else None
        if name == "sgd":
            def kernel():
                return o.sgd_update(ps, grads, moments[0], o.SGD_MOMENTUM, -2e-4, table)

            def plain():
                o.global_norm(grads)
                for p, g, t in zip(ps, grads, moments[0]):
                    o.sgd_update_plain(p, g, t, o.SGD_MOMENTUM, -2e-4)
        else:
            update = o.adam_lowp_update if name == "adam_lowp" else functools.partial(o.adam_update, weight_decay=wd)

            def kernel():
                return update(ps, grads, *moments, 0.9, 0.999, 1e-8, -2e-4, c1, c2, table)

            def plain():
                o.global_norm(grads)
                for p, g, m, v in zip(ps, grads, *moments):
                    o.adam_update_plain(p, g, m, v, 0.9, 0.999, 1e-8, -2e-4, c1, c2, wd)
        lib_params = [torch.nn.Parameter(b.clone()) for b in base]
        lib_grads = [torch.zeros_like(b) if g is None else g for b, g in zip(base, grads)]
        for p, g in zip(lib_params, lib_grads):
            p.grad = g
        library_opt = (torch.optim.SGD(lib_params, lr=2e-4, momentum=o.SGD_MOMENTUM, foreach=True) if name == "sgd"
                       else torch.optim.AdamW(lib_params, lr=2e-4, weight_decay=wd, fused=True) if name == "adamw"
                       else torch.optim.Adam(lib_params, lr=2e-4, fused=True))

        def library():
            torch.nn.utils.get_total_norm(lib_grads)
            library_opt.step()

        kernel()
        n_blocks = table.n_blocks
        ev = [event_ms(plain, 2, 3), event_ms(kernel), event_ms(kernel), event_ms(plain, 2, 3)]
        bound_ms, bound_by = bound(nbytes * n_params + 8 * n_blocks, nops * n_params)
        out[name] = {
            "ms": min(ev[1], ev[2]), "plain_ms": min(ev[0], ev[3]), "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": event_ms(library), "call_ms": call_ms(kernel, 20),
            "n_params": n_params, "blocks": n_blocks, "bytes_per_param": nbytes,
        }
        t = out[name]
        print(f"[timing] {name} ({symbol}) over {n_params} parameters, {n_blocks} blocks: CUDA events, update and "
              f"finish {t['ms']:.6f} ms, plain {t['plain_ms']:.6f} ms, library {t['library_ms']:.6f} ms; bound "
              f"{bound_ms:.6f} ms ({bound_by}), {100 * bound_ms / t['ms']:.1f}% of the bound; per call with the "
              f"host's launch cost {t['call_ms']:.5f} ms ({card})")
        del ps, moments, lib_params, library_opt
    return out


def results_epochs(path, want_chains):
    """The epochs of a results.json written in JAX's schema, each with its
    chain success rates 1..5; fails otherwise."""
    on_disk = json.loads(pathlib.Path(path).read_text())
    for epoch, r in on_disk.items():
        if set(r) != RESULT_KEYS or set(r["chain_sr"]) != {"1", "2", "3", "4", "5"}:
            fail(f"{path}: epoch {epoch} has keys {sorted(r)}, chain_sr {sorted(r['chain_sr'])}")
        attempts = sum(v["total"] for v in r["task_info"].values())
        if attempts < want_chains:
            fail(f"{path}: epoch {epoch} attempted {attempts} instructions over {want_chains} chains")
    return sorted(int(e) for e in on_disk)


def profiled_kernels(trace_path):
    """{csrc function name: kernels of it} in a Chrome trace."""
    events = json.loads(pathlib.Path(trace_path).read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(k in n for n in names) for k in PROFILED_TRAIN_KERNELS}


def run_clis(seed, card):
    """Phase 18's main path: the train CLI (``training.train.main``) on a
    200 / 84 px ``--fixture`` at the ``hulc`` preset's full width with
    AdamW (3 steps, then a relaunch to 5 with ``--steps-total``), SGD,
    fp32-moment Adam with the batched rollout callback, and the default
    optimizer with a profile window; the evaluate CLI
    (``evaluation.evaluate.main``) batched over every checkpoint of the
    AdamW run and sequentially over the SGD run's last; a synthetic
    reference ``.ckpt`` imported (``training.import_checkpoint``) and
    evaluated. Launch counts are zeroed before and read after."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.config import get_config
    from hulc_tpu_torch.evaluation import evaluate
    from hulc_tpu_torch.models import make_model
    from hulc_tpu_torch.training import checkpoint as ckpt
    from hulc_tpu_torch.training import import_checkpoint as importer
    from hulc_tpu_torch.training import train

    cfg = get_config("hulc")
    t0 = time.perf_counter()
    summary = {"train": {}, "evaluate": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_clis_") as tmp:
        tmp = pathlib.Path(tmp)
        saved_tempdir, tempfile.tempdir = tempfile.tempdir, str(tmp)  # the --fixture datasets go here
        try:
            def train_cli(run, *flags):
                t = time.perf_counter()
                trainer = train.main(["--config", "hulc", "--fixture", "--run-dir", str(tmp / run), "--seed",
                                      str(seed), *flags])
                torch.cuda.synchronize()
                rec = {"flags": list(flags), "step": trainer.step, "optimizer": trainer.optimizer.KIND,
                       "epochs": [ckpt.checkpoint_epoch(p) for p in ckpt.all_checkpoints(tmp / run)],
                       "s": time.perf_counter() - t}
                del trainer
                torch.cuda.empty_cache()
                summary["train"].setdefault(run, []).append(rec)
                print(f"[clis] train {' '.join(flags)}: step {rec['step']}, {rec['optimizer']}, checkpoints of epochs "
                      f"{rec['epochs']}, {rec['s']:.1f} s")
                return rec

            def evaluate_cli(run, *flags):
                t = time.perf_counter()
                evaluate.main(["--run-dir", str(tmp / run), "--config", "hulc", "--seed", str(seed), *flags])
                summary["evaluate"].setdefault(run, []).append({"flags": list(flags), "s": time.perf_counter() - t})
                return tmp / run / "evaluation" / "results.json"

            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            if train_cli("adamw", "--optimizer", "adamw", "--steps", "3")["step"] != 3:
                fail("train CLI: --steps 3 did not take 3 steps")
            relaunch = train_cli("adamw", "--optimizer", "adamw", "--steps-total", "5")
            if relaunch["step"] != 5 or relaunch["optimizer"] != "adamw":
                fail(f"train CLI: the relaunch with --steps-total 5 ended at {relaunch}")
            if train_cli("sgd", "--optimizer", "sgd", "--steps", "3")["optimizer"] != "sgd":
                fail("train CLI: --optimizer sgd built another optimizer")
            rollout = train_cli("rollout", "--adam-mv-dtype", "float32", "--steps", "3", "--rollout",
                                "--rollout-num-envs", str(CLI_LANES), "--rollout-sequences", str(CLI_CHAINS),
                                "--rollout-ep-len", str(CLI_EP_LEN))
            records = [json.loads(x) for x in (tmp / "rollout" / "metrics.jsonl").read_text().splitlines()]
            rolled = [r for r in records if r["prefix"] == "rollout"]
            if rollout["optimizer"] != "adam" or not rolled or not all("eval_lh/avg_seq_len" in r for r in rolled):
                fail(f"train CLI --rollout: optimizer {rollout['optimizer']}, rollout records {rolled}")
            summary["rollout_records"] = rolled

            profile_counts = None
            for attempt in range(PROFILE_RUNS):
                args = train.build_parser().parse_args(["--config", "hulc", "--fixture", "--steps", "3", "--run-dir",
                                                        str(tmp / f"profile{attempt}"), "--seed", str(seed)])
                run = train.build_run(args)
                run.trainer.tcfg.profile_start, run.trainer.tcfg.profile_steps = 1, 2
                run.trainer.fit(run.train_loader, run.val_loader, **run.fit_kwargs)
                traces = sorted((tmp / f"profile{attempt}" / "profile").glob("*.json"))
                del run
                torch.cuda.empty_cache()
                if [t.name for t in traces] != ["trace_steps_1-2.json"]:
                    fail(f"train profile window: traces {traces}, not trace_steps_1-2.json")
                profile_counts = profiled_kernels(traces[0])
                if all(profile_counts.values()):
                    break
                print(f"[clis] the profile window of steps 1-2 lost every launch of a kernel: {profile_counts}; "
                      f"running it again")
            else:
                fail(f"train profile window: a train kernel is missing from the trace: {profile_counts}")
            summary["profile_window"] = {"steps": [1, 2], "kernels": profile_counts, "runs": attempt + 1}
            print(f"[clis] profile_start=1, profile_steps=2: trace_steps_1-2.json names every train kernel "
                  f"({profile_counts})")
            torch.cuda.synchronize()
            train_launches = launch_counts()

            epochs = results_epochs(evaluate_cli("adamw", "--batched", "--num-envs", str(CLI_LANES), "--num-sequences",
                                                 str(CLI_CHAINS), "--ep-len", str(CLI_EP_LEN), "--checkpoint", "all"),
                                    CLI_CHAINS)
            if epochs != relaunch["epochs"]:
                fail(f"evaluate --checkpoint all: results for epochs {epochs}, checkpoints {relaunch['epochs']}")
            seq_epochs = results_epochs(evaluate_cli("sgd", "--num-sequences", str(SEQUENTIAL_CHAINS)),
                                        SEQUENTIAL_CHAINS)
            if seq_epochs != summary["train"]["sgd"][-1]["epochs"][-1:]:
                fail(f"evaluate (sequential, last): results for epochs {seq_epochs}")

            source = {k: v.cpu() for k, v in make_model(cfg, "cuda", seed=seed + 7).state_dict().items()}
            ckpt_file = tmp / "reference" / "epoch=3.ckpt"
            ckpt_file.parent.mkdir()
            torch.save({"state_dict": {**source, IMPORT_EXTRA_KEY: torch.zeros(3)}, "epoch": 3}, ckpt_file)
            path, unused = importer.import_checkpoint(ckpt_file, cfg, tmp / "imported")
            if unused != [IMPORT_EXTRA_KEY] or ckpt.checkpoint_epoch(path) != 3:
                fail(f"import: unused keys {unused}, checkpoint {path}")
            template = make_model(cfg, "cuda", seed=seed).state_dict()
            restored = ckpt.restore_params(path, template)
            if not all(torch.equal(restored[k].cpu(), v) for k, v in source.items()) or set(restored) != set(source):
                fail("import: the restored parameters are not the .ckpt's bit for bit")
            del template, restored
            imported_epochs = results_epochs(evaluate_cli("imported", "--batched", "--num-envs", str(CLI_LANES),
                                                          "--num-sequences", str(CLI_CHAINS), "--ep-len",
                                                          str(CLI_EP_LEN)), CLI_CHAINS)
            if imported_epochs != [3]:
                fail(f"evaluate on the imported run: epochs {imported_epochs}")
            torch.cuda.synchronize()
            launches = launch_counts()
            summary["import"] = {"parameters": sum(v.numel() for v in source.values()), "unused": unused,
                                 "restored_bit_equal": True}
            for run in ("adamw", "sgd", "imported"):
                summary["evaluate"][run][-1]["results"] = json.loads(
                    (tmp / run / "evaluation" / "results.json").read_text())
        finally:
            tempfile.tempdir = saved_tempdir
    eval_launches = {k: launches[k] - train_launches[k] for k in launches}
    print(f"[clis] launches: train CLIs {train_launches}; evaluate CLIs and the import {eval_launches}")
    if not all(train_launches[k] > 0 for k in CLI_TRAIN_KERNELS + CLI_EVAL_KERNELS):
        fail(f"a kernel of the train CLIs' path was never launched: {train_launches}")
    if not all(eval_launches[k] > 0 for k in CLI_EVAL_KERNELS) or any(
            eval_launches[k] for k in CLI_TRAIN_KERNELS if k not in CLI_EVAL_KERNELS):
        fail(f"the evaluate CLI's launches are not the serving kernels': {eval_launches}")
    summary.update(launches_train=train_launches, launches_evaluate=eval_launches, phase_s=time.perf_counter() - t0,
                   card=card)
    print(f"[clis] done in {summary['phase_s']:.1f} s ({card})")
    return summary, launches


def run_phase18(seed, card):
    """B.5' held and timed, then the CLIs' main path; returns (summary,
    launches, errs, timing)."""
    from hulc_tpu_torch.config import get_config
    from hulc_tpu_torch.models import make_model

    shapes = [p.shape for p in make_model(get_config("hulc"), "cuda", seed=seed).parameters()]
    if sum(int(np.prod(s)) for s in shapes) != HULC_PARAMS:
        fail(f"hulc has {sum(int(np.prod(s)) for s in shapes)} parameters, not {HULC_PARAMS}")
    t0 = time.perf_counter()
    checks = check_optimizer_instances(shapes, seed + 18)
    timing = time_optimizer_instances(shapes, seed + 19, card)
    torch.cuda.empty_cache()
    print(f"[optimizers] checked and timed in {time.perf_counter() - t0:.1f} s")
    summary, launches = run_clis(seed, card)
    summary["optimizer_norm_rel_err"] = {k: v[1] for k, v in checks.items()}
    summary["adam_lowp_events"] = timing.pop("adam_lowp")  # B.5 by events, beside its row's profiler time
    errs = {k: v[0] for k, v in checks.items() if k != "adam_lowp"}
    return summary, launches, errs, timing


# --------------------------------------------------------------------------
# phase 19: the BiRNN's relu and gru cells (B.13), dropout, the encoders' options
# --------------------------------------------------------------------------

B13_CELLS = ("gru", "rnn")
# every dropout site of the mcil path at the recognition transformer's rate (no preset sets them)
B13_DROPOUT = 0.1
B13_TRAIN_STEPS = 3
# each cell's chain kernels (forward, dh chain); the other BiRNN kernels must stay idle
B13_KERNELS = {"gru": ("hulc_rnn_gru_chain_fwd", "hulc_rnn_gru_chain_bwd"),
               "rnn": ("hulc_rnn_relu_chain_fwd", "hulc_rnn_relu_chain_bwd")}
B13_IDLE = ("hulc_rnn_tanh_fwd", "hulc_rnn_tanh_bwd", "hulc_birnn_tanh_fwd", "hulc_birnn_tanh_bwd")
# the encoders' options, all on, on hulc (the transformer's sinusoidal positions with both LayerNorms)
OPTION_OVERRIDES = (
    "perceptual_encoder.rgb_static.use_sinusoid=true", "perceptual_encoder.rgb_static.l2_normalize_output=true",
    "perceptual_encoder.rgb_gripper.l2_normalize_output=true", "visual_goal.l2_normalize=true",
    "language_goal.l2_normalize=true", "plan_recognition.position_embedding=false",
    "plan_recognition.positional_normalize=true", "plan_recognition.encoder_normalize=true",
)
# The decoder's B.6 (relu) and B.11 (gru) outputs on kernel_times.py's fixed inputs from seed 0, as that
# script digests them (``kernel_times.py --tree DIR --only rnn_relu_,rnn_gru_``) on the tree before B.13
# (commit 721cb30) on an H100: B.13's templates must leave the decoder's instances bit-equal.
PARENT_DIGESTS = {
    "rnn_relu_fwd 64 32": "1a2efa7475d961a5", "rnn_relu_bwd 64 32": "d78a0f763f7577fb",
    "rnn_relu_fwd 64 1": "7d8a84ba78ac7158", "rnn_relu_bwd 64 1": "5e1520afcf8585b0",
    "rnn_relu_fwd 1 1": "866d1a175783caf3", "rnn_relu_bwd 1 1": "9aa0161c027076a3",
    "rnn_gru_fwd 64 32": "2e5d18512fa201d0", "rnn_gru_bwd 64 32": "ea262e836a5b8050",
    "rnn_gru_fwd 64 1": "c61b4a6b0fc418e3", "rnn_gru_bwd 64 1": "1a63327abf551dc2",
    "rnn_gru_fwd 1 1": "8ef68b600c1c359b", "rnn_gru_bwd 1 1": "b3e71cbc97d3ecfc",
}


def b13_config(cell):
    """``mcil`` with the BiRNN's cell and the dropout sites set as a user
    sets them (``apply_overrides``, the train CLI's ``--set``)."""
    from hulc_tpu_torch.config import apply_overrides, get_config

    return apply_overrides(get_config("mcil"), b13_overrides(cell))


def b13_overrides(cell):
    return [f"plan_recognition.birnn_cell={cell}", f"plan_recognition.birnn_dropout={B13_DROPOUT}",
            f"action_decoder.rnn_dropout={B13_DROPOUT}", f"perceptual_encoder.rgb_static.dropout={B13_DROPOUT}",
            f"perceptual_encoder.rgb_gripper.dropout={B13_DROPOUT}"]


def b13_chain(cell, xp, h0, w, bias, y, d, saved=None, kernel=True):
    """Chain ``d`` of a layer (0 forward, 1 reverse) into its half of y (B,
    S, 2H): the kernel (B.13) or its plain mirror; the gru's gates into
    ``saved``."""
    from hulc_tpu_torch.ops import recurrence as rec

    h = w.shape[1]
    if cell == "gru":
        if kernel:
            rec._gru_chain_fwd_launch(xp, h0, w, bias, y, d * h, d == 1, saved)
        else:
            rec.gru_chain_fwd_plain(xp, h0, w, bias, y, d * h, d == 1, saved)
    elif kernel:
        rec._chain_fwd_launch(xp, h0, w, bias, y, d * h, d == 1, None, "rnn")
    else:
        rec.relu_chain_fwd_plain(xp, h0, w, bias, y, d * h, d == 1)
    return y


def b13_dh_chain(cell, dy, y, h0, saved, w, d, kernel=True):
    """Chain ``d``'s dh chain over its half of dy and y: gru (dxp, dhp,
    dh0), relu (dpre, dh0); the kernel or its plain mirror."""
    from hulc_tpu_torch.ops import recurrence as rec

    h = w.shape[1]
    b, s = y.shape[:2]
    if cell == "gru":
        if not kernel:
            return rec.gru_chain_bwd_plain(dy, None, y, h0, saved, w, d * h, d == 1)
        out = (y.new_empty(b, s, 3 * h), y.new_empty(b, s, 3 * h), y.new_empty(b, h))
        rec._gru_chain_bwd_launch(dy, y, h0, saved, w, *out, d * h, d == 1)
        return out
    if not kernel:
        return rec.relu_chain_bwd_plain(dy, y, None, w, d * h, d == 1)
    out = (y.new_empty(b, s, h), y.new_empty(b, h))
    rec._chain_bwd_launch(dy, y, None, w, *out, d * h, d == 1, "rnn")
    return out


def check_b13_chains(cell, chains, dy, where):
    """Each chain of one layer (forward and reverse, ``chains`` two (xp, h0,
    W_hh, b_hh)) through B.13's kernels against their plain mirrors on the
    same inputs: the forward's half of y (and the gru's saved gates), the
    dh chain's outputs on the plain forward's y, each within REC_REL
    relative L2. Returns ({row: max abs err}, {check: relative L2})."""
    b, s = dy.shape[:2]
    h = chains[0][2].shape[1]
    y_k, y_p = (torch.full((b, s, 2 * h), float("nan"), device="cuda") for _ in range(2))
    saved_k, saved_p = ((torch.empty((2, b, s, 4 * h), device="cuda") for _ in range(2)) if cell == "gru"
                        else (None, None))
    rel, fwd_abs, bwd_abs = {}, 0.0, 0.0
    for d, (xp, h0, w, bias) in enumerate(chains):
        direction = ("forward", "reverse")[d]
        b13_chain(cell, xp, h0, w, bias, y_k, d, None if saved_k is None else saved_k[d])
        b13_chain(cell, xp, h0, w, bias, y_p, d, None if saved_p is None else saved_p[d], kernel=False)
        half = slice(d * h, (d + 1) * h)
        rel[f"y {direction}"] = rel_l2(y_k[..., half], y_p[..., half])
        fwd_abs = max(fwd_abs, max_abs(y_k[..., half], y_p[..., half]))
        if cell == "gru":
            rel[f"saved {direction}"] = rel_l2(saved_k[d], saved_p[d])
            fwd_abs = max(fwd_abs, max_abs(saved_k[d], saved_p[d]))
        sv = None if saved_p is None else saved_p[d]
        got = b13_dh_chain(cell, dy, y_p, h0, sv, w, d)
        want = b13_dh_chain(cell, dy, y_p, h0, sv, w, d, kernel=False)
        for name, g, r in zip(("dxp", "dhp", "dh0") if cell == "gru" else ("dpre", "dh0"), got, want):
            rel[f"{name} {direction}"] = rel_l2(g, r)
            bwd_abs = max(bwd_abs, max_abs(g, r))
    if not max(rel.values()) <= REC_REL:
        fail(f"B.13 {cell} chains at {where} {(b, s, h)}: relative L2 {rel}")
    print(f"[b13] {cell} chains at {where} {(b, s, h)}, forward and reverse: forward relative L2 up to "
          f"{max(v for k, v in rel.items() if k.startswith(('y', 'saved'))):.3g} (max abs err {fwd_abs:.3g}), dh "
          f"chain up to {max(v for k, v in rel.items() if k.startswith('d')):.3g} (max abs err {bwd_abs:.3g})")
    fwd, bwd = (f"rnn_{'gru' if cell == 'gru' else 'relu'}_chain_{x}" for x in ("fwd", "bwd"))
    return {fwd: fwd_abs, bwd: bwd_abs}, rel


def check_b13_layer(cell, x, fwd, rev, dy, where):
    """One bidirectional layer of the cell through ``birnn_layer`` (the
    autograd Function: B.13's two chains forward, their dh chains and one dW
    product a chain backward) from zero states: the output against JAX's
    flip-and-concatenate definition (``birnn_layer_plain``), and the
    gradients of all seven inputs against the closed form on the Function's
    own output (each chain's plain dh chain, one dW product, the bias sum)
    and against autograd through the definition, each within REC_REL
    relative L2. A relu unit within rounding of zero can sit on the other
    side of it in the kernel's output than in the plain one's (the mask
    flips, and the dh chain carries that back through time): where any
    did, autograd's gradients are another function's, and they are printed
    beside the count, not held. Returns (the plain output, {check:
    relative L2})."""
    import torch.nn.functional as F

    from hulc_tpu_torch.ops import recurrence as rec

    with torch.no_grad():
        xp_f, xp_b = F.linear(x, fwd["weight_ih"], fwd["bias_ih"]), F.linear(x, rev["weight_ih"], rev["bias_ih"])
    h = fwd["weight_hh"].shape[1]
    inputs = (xp_f, xp_b, torch.zeros(2, x.shape[0], h, device="cuda"), fwd["weight_hh"], rev["weight_hh"],
              fwd["bias_hh"], rev["bias_hh"])
    leaves = [t.clone().requires_grad_() for t in inputs]
    got = rec.birnn_layer(*leaves, cell)
    k_grads = torch.autograd.grad(got, leaves, dy)
    leaves = [t.clone().requires_grad_() for t in inputs]
    want = rec.birnn_layer_plain(*leaves, cell)
    auto = torch.autograd.grad(want, leaves, dy)
    y, h0s = got.detach(), inputs[2]
    if cell == "gru":
        saved = torch.empty((2, *y.shape[:2], 4 * h), device="cuda")
        y_ref = torch.empty_like(y)
        for d in range(2):
            b13_chain(cell, inputs[d], h0s[d], inputs[3 + d], inputs[5 + d], y_ref, d, saved[d], kernel=False)
        y = y_ref  # the gru's dh chain reads the gates: the plain forward's, with its own y
    else:
        saved = None
    chains = [b13_dh_chain(cell, dy, y, h0s[d], None if saved is None else saved[d], inputs[3 + d], d, kernel=False)
              for d in range(2)]
    dhp = [c[1] if cell == "gru" else c[0] for c in chains]
    dw = [rec.recurrence_weight_grads(dhp[d], h0s[d], y[..., d * h:(d + 1) * h], reverse=d == 1) for d in range(2)]
    closed = (chains[0][0], chains[1][0], torch.stack([chains[0][-1], chains[1][-1]]), dw[0][0], dw[1][0], dw[0][1],
              dw[1][1])
    rel = {"y": rel_l2(got, want)}
    names = ("dxp_f", "dxp_b", "dh0s", "dW_hh_f", "dW_hh_b", "db_hh_f", "db_hh_b")
    for n, g, r in zip(names, k_grads, closed):
        rel[f"{n} vs closed form"] = rel_l2(g, r)
    flips = 0 if cell == "gru" else int(((got > 0) != (want > 0)).sum())
    vs_auto = {f"{n} vs autograd": rel_l2(g, r) for n, g, r in zip(names, k_grads, auto)}
    if not flips:
        rel.update(vs_auto)
    if not max(rel.values()) <= REC_REL:
        fail(f"B.13 {cell} layer at {where} {tuple(dy.shape)}: relative L2 {rel}")
    auto_txt = (f"and autograd through the definition" if not flips else
                f"(autograd through the definition up to {max(vs_auto.values()):.3g}: {flips} relu units of "
                f"{got.numel()} on the other side of zero than in the plain output)")
    print(f"[b13] {cell} layer at {where} {tuple(xp_f.shape[:2])} -> {tuple(dy.shape)}: y against "
          f"birnn_layer_plain and the seven gradients against the closed form {auto_txt} within relative L2 "
          f"{max(rel.values()):.3g}")
    return want.detach(), rel


def check_b13(cell, model, seed):
    """B.13 against its plain versions: each chain of both directions at the
    train step's (64, 32, 2048) on layer 0's and layer 1's W_hh (xp ~ N(0,
    1), a nonzero h0), one layer at a time through the Function from the
    model's input projections (layer 0 from 128 features, layer 1 from
    layer 0's 4096), and whole layers at odd shapes: H = 37 (plain loads,
    the gru's ring without the TMA unit), one step (3, 1, 37) and two row
    tiles (96, 3, 64). Returns ({row: max abs err}, {check: largest
    relative L2})."""
    from hulc_tpu_torch.ops.recurrence import GATES

    gen = torch.Generator(device="cuda").manual_seed(seed + 91)
    net = model.plan_recognition.birnn_model
    h, b, s, g = net.hidden_size, DECODER_ROWS, DECODER_SEQ, GATES.get(cell, 1)
    errs, worst = {}, {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def note(e, rel):
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        for k, v in rel.items():
            worst[k] = max(worst.get(k, 0.0), v)

    for k in range(net.num_layers):
        fwd, rev = birnn_params(net, k)
        chains = [(randn(b, s, g * h), torch.tanh(randn(b, h)), p["weight_hh"], p["bias_hh"]) for p in (fwd, rev)]
        note(*check_b13_chains(cell, chains, randn(b, s, 2 * h), f"the train step, layer {k}'s weights"))
    x = randn(b, s, net.weight_ih_l0.shape[1])
    for k in range(net.num_layers):
        x, rel = check_b13_layer(cell, x, *birnn_params(net, k), randn(b, s, 2 * h), f"the train step, layer {k}")
        note({}, rel)

    def uniform(hid, *shape):
        return (2.0 * torch.rand(shape, generator=gen, device="cuda") - 1.0) / hid**0.5

    for bb, ss, hid, where in ((3, 5, 37, "an odd shape"), (3, 1, 37, "one step"), (96, 3, 64, "two row tiles")):
        chains = [{"weight_ih": uniform(hid, g * hid, 11), "weight_hh": uniform(hid, g * hid, hid),
                   "bias_ih": uniform(hid, g * hid), "bias_hh": uniform(hid, g * hid)} for _ in range(2)]
        _, rel = check_b13_layer(cell, randn(bb, ss, 11), *chains, randn(bb, ss, 2 * hid), where)
        note({}, rel)
    return errs, worst


def time_b13(cell, model, seed):
    """Device ms of B.13's chain kernels at the train step's (64, 32, 2048)
    on layer 1's weights, forward and reverse chain (the gru's forward
    saving its gates), against their plain mirrors and cuDNN's nn.RNN(relu)
    / nn.GRU of the same weights (W_ih = I, b_ih = 0: the same function of
    xp; the dh chain's yardstick is cuDNN's backward alone), by CUDA events
    in turns plain, kernel, kernel, plain, with the bound: 2 B S H G H fp32
    FLOP a chain at 67 TFLOP/s. Then each whole layer (two chains)
    against cuDNN's bidirectional layer. The port never calls cuDNN."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.evaluation.kernel_times import event_ms
    from hulc_tpu_torch.ops import recurrence as rec

    gen = torch.Generator(device="cuda").manual_seed(seed + 93)
    net = model.plan_recognition.birnn_model
    h, b, s = net.hidden_size, DECODER_ROWS, DECODER_SEQ
    g = rec.GATES.get(cell, 1)
    fwd, rev = birnn_params(net, 1)
    xp = torch.randn((b, s, g * h), generator=gen, device="cuda")
    h0, h0s = torch.zeros((b, h), device="cuda"), torch.zeros((2, b, h), device="cuda")
    dy = torch.randn((b, s, 2 * h), generator=gen, device="cuda")
    saved = torch.empty((2, b, s, 4 * h), device="cuda") if cell == "gru" else None
    y = torch.empty((b, s, 2 * h), device="cuda")
    for d, p in enumerate((fwd, rev)):
        b13_chain(cell, xp, h0, p["weight_hh"], p["bias_hh"], y, d, None if saved is None else saved[d],
                  kernel=False)
    make = (lambda: torch.nn.GRU(g * h, h, batch_first=True, bidirectional=bi, device="cuda")) if cell == "gru" else (
        lambda: torch.nn.RNN(h, h, nonlinearity="relu", batch_first=True, bidirectional=bi, device="cuda"))
    libs = {}
    for bi in (False, True):
        libs[bi] = make()
        with torch.no_grad():
            for sfx, p in (("", fwd), ("_reverse", rev))[:1 + bi]:
                getattr(libs[bi], f"weight_ih_l0{sfx}").copy_(torch.eye(g * h, device="cuda"))
                getattr(libs[bi], f"bias_ih_l0{sfx}").zero_()
                getattr(libs[bi], f"weight_hh_l0{sfx}").copy_(p["weight_hh"])
                getattr(libs[bi], f"bias_hh_l0{sfx}").copy_(p["bias_hh"])
            want = y if bi else y[..., :h]
            lib_y = libs[bi](xp, torch.zeros((1 + bi, b, h), device="cuda"))[0]
            if rel_l2(lib_y, want) > 1e-4:
                fail(f"cuDNN's {cell} (bidirectional {bi}) does not compute the recurrence: relative L2 "
                     f"{rel_l2(lib_y, want)}")
    lib_in = {bi: (xp.clone().requires_grad_(), torch.zeros((1 + bi, b, h), device="cuda", requires_grad=True))
              for bi in (False, True)}
    lib_out = {bi: libs[bi](*lib_in[bi])[0] for bi in (False, True)}

    def lib_bwd(bi, cot):
        return lambda: torch.autograd.grad(lib_out[bi], [*lib_in[bi], *libs[bi].parameters()], cot, retain_graph=True)

    def chain_fwd(d, kernel):
        p = (fwd, rev)[d]
        sv = None if saved is None else saved[d]
        return lambda: b13_chain(cell, xp, h0, p["weight_hh"], p["bias_hh"], torch.empty_like(y), d, sv, kernel)

    def chain_bwd(d, kernel):
        p = (fwd, rev)[d]
        return lambda: b13_dh_chain(cell, dy, y, h0, None if saved is None else saved[d], p["weight_hh"], d, kernel)

    bsh, flops = b * s * h, 2 * b * s * h * g * h
    sv = 4 * bsh if cell == "gru" else 0  # the gru's saved gates, written forward and read by the dh chain
    # forward: xp in, its half of y out (and the saved gates), W, b_hh, h0; dh chain: dy, y (and the saved
    # gates and h0) in, dxp (and dhp) and dh0 out, W
    fwd_bytes = 4 * (g * bsh + bsh + sv + g * h * h + g * h + b * h)
    bwd_bytes = 4 * (2 * bsh + sv + (2 * g if cell == "gru" else 1) * bsh + g * h * h + 2 * b * h)
    kind = "gru" if cell == "gru" else "relu"
    cases = {
        f"rnn_{kind}_chain_fwd": (chain_fwd, bound(fwd_bytes, flops), lambda: libs[False](xp, h0[None])),
        f"rnn_{kind}_chain_bwd": (chain_bwd, bound(bwd_bytes, flops), lib_bwd(False, dy[..., :h].contiguous())),
    }
    out = {}
    for name, (make_fn, (bound_ms, bound_by), library_fn) in cases.items():
        row = {"bound_ms": bound_ms, "bound_by": bound_by, "library_ms": event_ms(library_fn, 5),
               "timed_by": "CUDA events", "shape": [b, s, h]}
        for d, direction in enumerate(("forward", "reverse")):
            kernel_fn, plain_fn = make_fn(d, True), make_fn(d, False)
            ms_ = [event_ms(plain_fn, 3), event_ms(kernel_fn, 10), event_ms(kernel_fn, 10), event_ms(plain_fn, 3)]
            row[direction] = {"ms": min(ms_[1], ms_[2]), "plain_ms": min(ms_[0], ms_[3])}
        row["ms"], row["plain_ms"] = row["forward"]["ms"], row["forward"]["plain_ms"]
        row["call_ms"], row["plain_call_ms"] = call_ms(make_fn(0, True), 10), call_ms(make_fn(0, False), 3)
        row["library"] = (f"cuDNN nn.{'GRU' if cell == 'gru' else 'RNN(relu)'}, one direction, W_ih = I, fp32"
                          + ("; the backward alone" if name.endswith("bwd") else ""))
        out[name] = row
    # the whole layer: both chains, against cuDNN's bidirectional layer
    layer_fwd = lambda: rec.birnn_layer_fwd(xp, xp, h0s, fwd["weight_hh"], rev["weight_hh"], fwd["bias_hh"],  # noqa
                                            rev["bias_hh"], cell, saved)
    layer_bwd = lambda: rec.birnn_layer_bwd(dy, y, fwd["weight_hh"], rev["weight_hh"], cell, h0s, saved)  # noqa
    out[f"birnn_{kind}_layer"] = {
        "forward_ms": event_ms(layer_fwd, 5), "backward_ms": event_ms(layer_bwd, 5),
        "library_forward_ms": event_ms(lambda: libs[True](xp, h0s), 5),
        "library_backward_ms": event_ms(lib_bwd(True, dy), 5), "bound_ms": 2 * cases[f"rnn_{kind}_chain_fwd"][1][0],
        "timed_by": "CUDA events", "shape": [b, s, 2 * h],
    }
    ptxas = kernels.ptxas_report(kernels.build().with_suffix(".log").read_text())
    names = {"fwd": "gated_fwd_kernel<false, true>", "bwd": "gated_bwd_kernel<false, true>"} if cell == "gru" else {
        "fwd": "rnn_fwd_kernel<false, true>", "bwd": "rnn_bwd_kernel<false, true>"}
    for x in ("fwd", "bwd"):
        backward = x == "bwd"
        if cell == "gru":
            plan = rec.gated_device_plan("gru", h, b, s, torch.cuda.current_device(), backward, not backward, True)
            out[f"rnn_{kind}_chain_{x}"]["plan"] = {**dataclasses.asdict(plan), "blocks": plan.blocks(h)}
        else:
            out[f"rnn_{kind}_chain_{x}"]["plan"] = dataclasses.asdict(recurrence_plan_for(b, s, h, backward))
        out[f"rnn_{kind}_chain_{x}"]["registers"] = ptxas[names[x]]["registers"]
    return out


def b13_sites(model):
    """The model's dropout sites that draw (p > 0), by name."""
    from hulc_tpu_torch.models.layers import Dropout

    return sorted(n for n, m in model.named_modules() if isinstance(m, Dropout) and m.p > 0)


def run_b13_cell(cell, seed, card):
    """``mcil`` with the BiRNN's ``cell`` and dropout at every site: B.13
    checked and timed, then the main path (launch counts zeroed just before
    and read just after): B13_TRAIN_STEPS train steps and a val step; then
    one train step against the plain path with the same generator state
    (the same dropout masks; compare_train_plain's rule). Returns (summary,
    launches, errs, timing)."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.models import make_model
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ, synthetic_fused_batch
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    cfg = b13_config(cell)
    model = make_model(cfg, "cuda", seed=seed)
    sites = b13_sites(model)
    print(f"[b13] mcil with birnn_cell={cell}, {sum(p.numel() for p in model.parameters())} parameters, dropout "
          f"{B13_DROPOUT} at {sites}")
    want_sites = ["action_decoder.rnn.dropouts.0", "perceptual_encoder.rgb_gripper_encoder.dropout",
                  "perceptual_encoder.rgb_static_encoder.dropout", "plan_recognition.birnn_model.dropouts.0"]
    if sites != want_sites:
        fail(f"b13 {cell}: the dropout sites that draw are {sites}, not {want_sites}")
    errs, worst = check_b13(cell, model, seed)
    timing = time_b13(cell, model, seed)
    for name, t in timing.items():
        if "forward" in t and isinstance(t["forward"], dict):
            print(f"[b13] {name} at {tuple(t['shape'])}: kernel {t['forward']['ms']:.6f} ms (reverse chain "
                  f"{t['reverse']['ms']:.6f} ms), plain {t['plain_ms']:.6f} ms, cuDNN {t['library_ms']:.6f} ms, bound "
                  f"{t['bound_ms']:.6f} ms ({t['bound_by']}), {100 * t['bound_ms'] / t['ms']:.1f}% of the bound; "
                  f"plan {t['plan']}, {t['registers']} registers (CUDA events, {card})")
        else:
            print(f"[b13] {name} at {tuple(t['shape'])}: forward {t['forward_ms']:.6f} ms, dh chains "
                  f"{t['backward_ms']:.6f} ms; cuDNN's bidirectional layer forward {t['library_forward_ms']:.6f} ms, "
                  f"backward {t['library_backward_ms']:.6f} ms; bound {t['bound_ms']:.6f} ms a direction pair "
                  f"(CUDA events, {card})")

    batch = synthetic_fused_batch(cfg, BATCH_PER_MOD, SEQ, seed, "cuda")
    trainer = Trainer(cfg, TrainerConfig(seed=seed), "cuda")
    trainer.model.load_state_dict(model.state_dict())
    trainer.init_state(1)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step_losses, host, _ = drive_training(trainer, batch, cfg.loss.kl_beta, B13_TRAIN_STEPS)
    per_step = launch_counts()
    trainer.model.eval()
    with torch.no_grad():
        val = trainer.val_step(split_fused(batch), cfg.loss.kl_beta,
                               generator=torch.Generator(device="cuda").manual_seed(seed))
    trainer.model.train()
    torch.cuda.synchronize()
    launches = launch_counts()
    fwd, bwd = B13_KERNELS[cell]
    other = B13_KERNELS["rnn" if cell == "gru" else "gru"]
    layers = cfg.plan_recognition.birnn_num_layers
    if per_step[fwd] != 2 * layers * B13_TRAIN_STEPS or per_step[bwd] != 2 * layers * B13_TRAIN_STEPS:
        fail(f"b13 {cell}: {B13_TRAIN_STEPS} train steps launched {fwd} {per_step[fwd]} and {bwd} {per_step[bwd]} "
             f"times, not {2 * layers * B13_TRAIN_STEPS} each: a step runs each layer's two chains once")
    if not launches[fwd] > per_step[fwd] or any(launches[k] for k in (*other, *B13_IDLE)):
        fail(f"b13 {cell}: the val step did not launch {fwd}, or another BiRNN kernel ran: {launches}")
    for i, losses in enumerate(step_losses):
        if not all(np.isfinite(v) for v in losses.values()):
            fail(f"b13 {cell} train step {i}: a loss is not finite: {losses}")
    if not all(np.isfinite(float(v)) for v in val.values()):
        fail(f"b13 {cell} val step: a metric is not finite: {val}")
    print(f"[b13 main path] {cell}: {B13_TRAIN_STEPS} train steps (host ms {[round(t, 3) for t in host]}, {card}), "
          f"total losses {[round(l['total_loss'], 5) for l in step_losses]}, a val step ({len(val)} metrics, all "
          f"finite); launches {({k: launches[k] for k in (fwd, bwd)})}")
    del trainer
    train_check = compare_train_plain(cfg, model, batch, seed, label=f"b13 {cell} train plain path")
    del model
    torch.cuda.empty_cache()
    summary = {"train_steps_host_ms": host, "losses": step_losses, "plain_path": train_check,
               "dropout_sites": sites, "check_rel_l2": worst, "s": time.perf_counter() - t0}
    return summary, launches, errs, timing


def run_b13_cli(seed, card):
    """The train CLI in-process (``training.train.main``) for 3 steps on a
    200 / 84 px ``--fixture`` with ``mcil`` and the gru BiRNN and the
    dropout sites set by ``--set``; launch counts zeroed before and read
    after."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.training import train

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_b13_") as tmp:
        saved_tempdir, tempfile.tempdir = tempfile.tempdir, tmp  # the --fixture dataset goes here
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            sets = [arg for o in b13_overrides("gru") for arg in ("--set", o)]
            trainer = train.main(["--config", "mcil", "--fixture", "--steps", "3", "--run-dir", f"{tmp}/run",
                                  "--seed", str(seed), *sets])
            torch.cuda.synchronize()
            launches = launch_counts()
            step, cell = trainer.step, trainer.cfg.plan_recognition.birnn_cell
            records = [json.loads(x) for x in (pathlib.Path(tmp) / "run" / "metrics.jsonl").read_text().splitlines()]
            del trainer
            torch.cuda.empty_cache()
        finally:
            tempfile.tempdir = saved_tempdir
    if step != 3 or cell != "gru" or not all(launches[k] for k in B13_KERNELS["gru"]):
        fail(f"b13 train CLI: step {step}, cell {cell}, launches {launches}")
    if not all(np.isfinite(v) for r in records for k, v in r.items() if k != "prefix"):
        fail(f"b13 train CLI: a logged value is not finite: {records}")
    print(f"[b13 main path] train CLI --config mcil with {' '.join(sets)}: {step} steps, "
          f"{len(records)} metrics lines, {time.perf_counter() - t0:.1f} s ({card})")
    return {"steps": step, "records": len(records), "s": time.perf_counter() - t0}, launches


def run_b13_options(seed, lanes, card):
    """``hulc`` with the encoders' options all on (OPTION_OVERRIDES): one
    train step against the plain path (compare_train_plain's rule), and a
    policy step at one lane and at ``lanes`` lanes against the plain path
    (ACTION_ATOL, plan ties counted)."""
    from hulc_tpu_torch.config import apply_overrides, get_config
    from hulc_tpu_torch.models import make_model
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ, synthetic_fused_batch

    t0 = time.perf_counter()
    cfg = apply_overrides(get_config("hulc"), OPTION_OVERRIDES)
    model = make_model(cfg, "cuda", seed=seed)
    batch = synthetic_fused_batch(cfg, BATCH_PER_MOD, SEQ, seed, "cuda")
    train_check = compare_train_plain(cfg, model, batch, seed, label="encoder options train plain path")
    rng = np.random.default_rng(seed + 95)
    lang = rng.normal(size=cfg.lang_dim).astype(np.float32)
    langs = rng.normal(size=(lanes, cfg.lang_dim)).astype(np.float32)
    single_obs, batched_obs = make_obs(rng, cfg, 1), [make_obs(rng, cfg, lanes)]
    single_actions, single_states = drive_single(cfg, model, single_obs, lang, seed)
    batched_actions, batched_states = drive_batched(cfg, model, batched_obs, langs, seed)
    plain_model = make_model(cfg, "cuda", seed=seed, use_kernels=False)
    plain_model.load_state_dict(model.state_dict())
    p_actions, p_plans = plain_single(cfg, plain_model, single_obs, lang, seed, single_states)
    single_err = compare_plain("options single lane", single_actions, p_actions,
                               single_states[1].plan[0].cpu().numpy()[None], p_plans, np.ones(1, bool), cfg)
    mask = replan_mask(0, lanes, cfg.replan_freq)
    p_actions, p_plans = plain_batched(cfg, plain_model, [(batched_obs[0], langs, batched_states[0], mask)], seed)
    batched_err = compare_plain(f"options batched, {lanes} lanes", batched_actions, p_actions,
                                batched_states[1][0].cpu().numpy()[None], p_plans, mask[None], cfg)
    del model, plain_model
    torch.cuda.empty_cache()
    print(f"[b13] encoder options {list(OPTION_OVERRIDES)} held against the plain path in "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    return {"overrides": list(OPTION_OVERRIDES), "train_step": train_check,
            "policy_plain_max_abs_err": {"1": single_err, str(lanes): batched_err}}


def check_decoder_digests(card):
    """The decoder's B.6 and B.11 forward and dh chain on kernel_times.py's
    fixed inputs, digested as that script does, against the tree before
    B.13 (PARENT_DIGESTS): bit-equal."""
    from hulc_tpu_torch.evaluation import kernel_times

    out = kernel_times.run(["--tree", str(pathlib.Path(__file__).resolve().parent), "--only", "rnn_relu_,rnn_gru_"])
    got = out["digest"]
    if set(got) != set(PARENT_DIGESTS) or any(got[k] != v for k, v in PARENT_DIGESTS.items()):
        fail(f"the decoder's B.6 / B.11 outputs are not the parent tree's: {got} against {PARENT_DIGESTS}")
    print(f"[b13] the decoder's B.6 and B.11 outputs bit-equal to the tree before B.13 ({len(got)} digests); CUDA "
          f"events ms {out['event_ms']} ({card})")
    return out["event_ms"]


def run_phase19(seed, lanes, card):
    """Phase 19: B.13 on both cells' mcil paths, the train CLI, the encoder
    options on hulc, and the decoder's instances against the parent's
    digests. Returns (summary, launches on the main paths, errs, timing)."""
    t0 = time.perf_counter()
    summary, launches, errs, timing = {}, collections.Counter(), {}, {}
    for cell in B13_CELLS:
        summary[cell], cell_launches, cell_errs, cell_timing = run_b13_cell(cell, seed, card)
        launches.update(cell_launches)
        errs.update(cell_errs)
        timing.update(cell_timing)
    summary["train_cli"], cli_launches = run_b13_cli(seed, card)
    launches.update(cli_launches)
    summary["options"] = run_b13_options(seed, lanes, card)
    summary["decoder_event_ms"] = check_decoder_digests(card)
    summary["s"] = time.perf_counter() - t0
    print(f"[b13] phase 19 in {summary['s']:.1f} s")
    return summary, launches, errs, timing


# --------------------------------------------------------------------------
# phase 20: data-parallel and ZeRO-3 training
# --------------------------------------------------------------------------

PARALLEL_REL = 1e-5  # N ranks against one device: relative L2 of each loss, norm and parameter
PARALLEL_STEPS = 3  # steps held against the one-device run
PARALLEL_TIMED_STEPS = 5  # then timed, with cuDNN's fastest algorithms
MAX_RANKS = 4
PARALLEL_EQUAL_LOSS = 1e-3  # the JAX package's full-size equal-loss rule, |a - b| / max(1, |b|)


def parallel_steps(trainer, batch, kl_beta, steps):
    """(losses averaged over the ranks per step, host ms per step)."""
    losses, host = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.train_step(batch, kl_beta)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        losses.append(trainer.host_scalars(out))
    return losses, host


def against(params, want_path):
    """Each parameter's relative L2 against a saved one-device state_dict,
    and whether all are bit-equal (compared on the device). An attention's
    key bias is held on its query and value thirds: its gradient is zero
    in exact arithmetic (a constant added to every key of a query cancels
    in its softmax), so Adam steps it on rounding noise, which ranks
    round otherwise."""
    want = torch.load(want_path, map_location="cuda", weights_only=True)
    rel = {}
    for k, v in params.items():
        w = want[k]
        if k.endswith("self_attn.in_proj_bias"):
            d = w.numel() // 3
            v, w = torch.cat([v[:d], v[2 * d:]]), torch.cat([w[:d], w[2 * d:]])
        rel[k] = rel_l2(v, w)
    return rel, all(torch.equal(v, want[k]) for k, v in params.items())


@contextlib.contextmanager
def deterministic_cudnn(on: bool = True):
    """cuDNN's deterministic algorithms (no atomics in the convolutions'
    backward; twice the step's time): the ranks and this process then
    compute the same sums. ``on=False``: its default algorithms."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = on, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def timed_steps(trainer, batch, kl_beta):
    """PARALLEL_TIMED_STEPS more steps on cuDNN's default algorithms; their
    host ms (the first warms the algorithms up)."""
    with deterministic_cudnn(False):
        return parallel_steps(trainer, batch, kl_beta, PARALLEL_TIMED_STEPS)[1]


def phase20_rank(spec):
    """One rank of phase 20 (a fresh process in the group): the DDP and FSDP
    steps on this rank's rows, the launch counts of both, then the FSDP
    trainer's step from the CLI's checkpoint. Rank 0 compares the
    parameters with the one-device files."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.config import get_config
    from hulc_tpu_torch.parallel import mesh
    from hulc_tpu_torch.training.preprocess import batch_to_device
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.library()
    cfg = get_config("hulc")
    batch = batch_to_device(mesh.shard_rows(spec["batch"]), "cuda")  # on the device, as phase 8's steps
    kl_beta = cfg.loss.kl_beta
    out = {"rank": mesh.rank(), "world": mesh.world(), "runs": {}}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    trainers = {}
    for mode in ("ddp", "fsdp"):
        tcfg = TrainerConfig(seed=spec["seed"], fsdp=mode == "fsdp", data_parallel=True if mode == "ddp" else None)
        trainer = Trainer(cfg, tcfg, "cuda")
        trainer.init_state(1)
        with deterministic_cudnn():
            losses, _ = parallel_steps(trainer, batch, kl_beta, PARALLEL_STEPS)
        params = trainer.params()
        run = {"losses": losses, "grad_copies": trainer.optimizer.grad_copies,
               "grad_copy_bytes": trainer.optimizer.grad_copy_bytes}
        if mesh.rank() == 0:
            run["param_rel"], run["bit_equal"] = against(params, spec["reference"])
        del params
        run["host_ms"] = timed_steps(trainer, batch, kl_beta)
        out["runs"][mode] = run
        trainers[mode] = trainer
    torch.cuda.synchronize()
    out["launches"] = {k.symbol: k.launches for k in kernels.ALL_KERNELS}
    del trainers["ddp"]
    # the gradient copies' cost: one copy of as many bytes, by CUDA events
    n = out["runs"]["fsdp"]["grad_copy_bytes"] // (PARALLEL_STEPS + PARALLEL_TIMED_STEPS) // 4
    if n:
        src, dst = torch.randn(n, device="cuda"), torch.empty(n, device="cuda")
        out["grad_copy_ms"] = time_events(lambda: dst.copy_(src), 20)
    # the CLI's checkpoint, resumed by the sharded trainer
    trainer = trainers["fsdp"]
    trainer.restore(spec["checkpoint"])
    with deterministic_cudnn():
        losses, _ = parallel_steps(trainer, batch, kl_beta, 1)
    params = trainer.params()
    out["resume"] = {"losses": losses[0]}
    if mesh.rank() == 0:
        out["resume"]["param_rel"], out["resume"]["bit_equal"] = against(params, spec["resumed"])
    return out


def time_events(fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls by CUDA events, after a
    warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def torchrun_cli(run_dir, seed, ranks, tmp):
    """The train CLI under ``torchrun --fsdp`` for 3 steps on the 200 / 84
    px fixture (rank 0 writes the fixture into ``tmp``); fails unless every
    rank exits 0."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(ranks),
           "-m", "hulc_tpu_torch.training.train", "--config", "hulc", "--fixture", "--steps", str(PARALLEL_STEPS),
           "--fsdp", "--run-dir", str(run_dir), "--seed", str(seed), "--val-max-batches", "1", "--log-every", "1"]
    env = dict(os.environ, TMPDIR=str(tmp),
               PYTHONPATH=os.pathsep.join([str(pathlib.Path(__file__).resolve().parent),
                                           os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-8000:], file=sys.stderr)
        fail(f"torchrun --fsdp train CLI exited {proc.returncode}")
    return time.perf_counter() - t0, proc.stdout


def run_parallel(seed, card):
    """Phase 20. Returns (summary, launches summed over the ranks)."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.config import get_config
    from hulc_tpu_torch.parallel import mesh
    from hulc_tpu_torch.training import checkpoint as ckpt
    from hulc_tpu_torch.training.preprocess import batch_to_device
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ, synthetic_fused_batch
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = get_config("hulc")
    ranks = min(torch.cuda.device_count(), MAX_RANKS)
    host_batch = synthetic_fused_batch(cfg, BATCH_PER_MOD, SEQ, seed, "cpu")  # each rank uploads its rows
    batch = batch_to_device(host_batch, "cuda")
    summary = {"ranks": ranks, "batch": 2 * BATCH_PER_MOD, "seq": SEQ}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp, deterministic_cudnn():
        tmp = pathlib.Path(tmp)
        # the one-device run
        trainer = Trainer(cfg, TrainerConfig(seed=seed), "cuda")
        trainer.init_state(1)
        one_losses, _ = parallel_steps(trainer, batch, cfg.loss.kl_beta, PARALLEL_STEPS)
        torch.save(trainer.params(), tmp / "reference.pt")
        one_host = timed_steps(trainer, batch, cfg.loss.kl_beta)
        del trainer
        # the CLI under torchrun, and its checkpoint resumed in one process
        cli_s, cli_out = torchrun_cli(tmp / "cli", seed, ranks, tmp)
        latest = ckpt.latest_checkpoint(tmp / "cli")
        lines = [json.loads(x) for x in (tmp / "cli" / "metrics.jsonl").read_text().splitlines()]
        train_lines = [x for x in lines if x["prefix"] == "train"]
        if latest is None or [x["step"] for x in train_lines] != list(range(1, PARALLEL_STEPS + 1)):
            fail(f"torchrun --fsdp CLI: checkpoint {latest}, train log steps {[x['step'] for x in train_lines]} "
                 f"(rank 0 alone writes one line a step)")
        resumed = Trainer(cfg, TrainerConfig(seed=seed), "cuda")
        resumed.init_state(1)
        resumed.restore(latest)
        if resumed.step != PARALLEL_STEPS or resumed.optimizer.count != PARALLEL_STEPS:
            fail(f"the CLI's checkpoint resumed at step {resumed.step}, optimizer count {resumed.optimizer.count}")
        resume_losses, _ = parallel_steps(resumed, batch, cfg.loss.kl_beta, 1)
        torch.save(resumed.params(), tmp / "resumed.pt")
        del resumed
        # a hulc_depth step's depth noise on rank 0 of two: B.10 draws only the
        # rank's rows of the global draw (of both halves of the fused batch)
        from hulc_tpu_torch.ops.depth_noise import prep_depth_draw

        depth = get_config("hulc_depth").perceptual_encoder
        frames = [torch.rand((BATCH_PER_MOD, SEQ, e.input_size, e.input_size), device="cuda")
                  for e in (depth.depth_static, depth.depth_gripper)]
        depth_ms = time_events(lambda: [prep_depth_draw(x, "gamma", 0.0, seed, 0, (2, 2, 0)) for x in frames], 5)
        depth_mb = sum(8 * x.numel() for x in frames) / 1e6
        del frames
        torch.cuda.empty_cache()
        # the ranks
        spec = {"batch": host_batch, "seed": seed, "reference": str(tmp / "reference.pt"), "resumed": str(tmp / "resumed.pt"),
                "checkpoint": str(latest)}
        t0 = time.perf_counter()
        results = mesh.spawn_ranks(phase20_rank, ranks, "cuda", (spec,))
        ranks_s = time.perf_counter() - t0

    launches = collections.Counter()
    for r in results:
        missing = [k for k in TRAIN_KERNELS if r["launches"][k] <= 0]
        if missing:
            fail(f"phase 20: rank {r['rank']} never launched {missing}: {r['launches']}")
        launches.update(r["launches"])
    r0 = results[0]
    for mode, run in r0["runs"].items():
        for i, (got, want) in enumerate(zip(run["losses"], one_losses)):
            for key in ("total_loss", "grad_norm"):
                err = abs(got[key] - want[key]) / max(abs(want[key]), 1e-30)
                if not np.isfinite(got[key]) or err > PARALLEL_REL:
                    fail(f"phase 20 {mode} step {i}: {key} {got[key]} against one device's {want[key]} "
                         f"(relative {err:.3g} > {PARALLEL_REL})")
        worst = max(run["param_rel"].items(), key=lambda kv: kv[1])
        if worst[1] > PARALLEL_REL:
            fail(f"phase 20 {mode}: parameter {worst[0]} after step {PARALLEL_STEPS} is {worst[1]:.3g} relative L2 "
                 f"from one device's (> {PARALLEL_REL})")
        print(f"[parallel] {mode} at {ranks} rank(s) over NCCL: {PARALLEL_STEPS} steps' total_loss "
              f"{[round(l['total_loss'], 6) for l in run['losses']]} and grad_norm "
              f"{[round(l['grad_norm'], 6) for l in run['losses']]} within {PARALLEL_REL} of one device's; every "
              f"parameter within {worst[1]:.3g} relative L2 ({worst[0]}); bit-equal to one device: {run['bit_equal']}")
    res = r0["resume"]
    for key in ("total_loss", "grad_norm"):
        err = abs(res["losses"][key] - resume_losses[0][key]) / abs(resume_losses[0][key])
        if err > PARALLEL_REL:
            fail(f"phase 20: the resumed step's {key} differs by {err:.3g} between the FSDP ranks and one process")
    worst = max(res["param_rel"].items(), key=lambda kv: kv[1])
    if worst[1] > PARALLEL_REL:
        fail(f"phase 20: after the resumed step {worst[0]} is {worst[1]:.3g} relative L2 from one process's")
    print(f"[parallel] torchrun --fsdp CLI: {PARALLEL_STEPS} steps on {ranks} rank(s), rank 0's checkpoint "
          f"{latest.name} resumed in one process without a group; its next step (total_loss "
          f"{resume_losses[0]['total_loss']:.6f}) against the FSDP ranks' from the same checkpoint: every parameter "
          f"within {worst[1]:.3g} relative L2, bit-equal {res['bit_equal']}; the CLI took {cli_s:.1f} s")
    if ranks >= 2:
        for mode, run in r0["runs"].items():
            for got, want in zip(run["losses"], one_losses):
                if abs(got["total_loss"] - want["total_loss"]) / max(1.0, abs(want["total_loss"])) >= PARALLEL_EQUAL_LOSS:
                    fail(f"phase 20 {mode}: the equal-loss rule fails at {ranks} ranks")
        print(f"[parallel] equal-loss rule (relative {PARALLEL_EQUAL_LOSS}): {ranks} ranks against one device ok")
    else:
        print("[parallel] the equal-loss check of N ranks against one device needs a second card: not run "
              "(neither a pass nor a failure)")
    one_ms = statistics.median(one_host[1:])
    times = {mode: statistics.median(run["host_ms"][1:]) for mode, run in r0["runs"].items()}
    fsdp = r0["runs"]["fsdp"]
    summary.update({
        "one_device_step_ms": one_ms, "ddp_step_ms": times["ddp"], "fsdp_step_ms": times["fsdp"],
        "steps_host_ms": {"one_device": one_host, **{m: r["host_ms"] for m, r in r0["runs"].items()}},
        "bit_equal": {m: r["bit_equal"] for m, r in r0["runs"].items()},
        "grad_copies_per_step": fsdp["grad_copies"] / (PARALLEL_STEPS + PARALLEL_TIMED_STEPS),
        "grad_copy_mb_per_step": fsdp["grad_copy_bytes"] / (PARALLEL_STEPS + PARALLEL_TIMED_STEPS) / 1e6,
        "grad_copy_ms_per_step": r0.get("grad_copy_ms", 0.0),
        "depth_noise_mb_per_rank": depth_mb, "depth_noise_draw_ms": depth_ms,
        "cli_s": cli_s, "ranks_s": ranks_s, "resume_bit_equal": res["bit_equal"],
        "launches_per_rank": [r["launches"] for r in results],
    })
    print(f"[timing] train step at {ranks} rank(s), 2B = {2 * BATCH_PER_MOD}, S = {SEQ}, host clock median of "
          f"{PARALLEL_TIMED_STEPS - 1} steps after a warm-up, cuDNN's default algorithms: one device {one_ms:.4f} ms, DDP {times['ddp']:.4f} ms "
          f"({times['ddp'] / one_ms:.4f}x), FSDP2 {times['fsdp']:.4f} ms ({times['fsdp'] / one_ms:.4f}x) ({card})")
    print(f"[timing] FSDP2: {summary['grad_copies_per_step']:.1f} gradient shards a step copied to their parameter's "
          f"phase, {summary['grad_copy_mb_per_step']:.3f} MB, {summary['grad_copy_ms_per_step']:.6f} ms of device time "
          f"as one copy ({card})")
    print(f"[timing] hulc_depth's depth noise on rank 0 of 2 (B.10 draws the rank's rows in its launch): "
          f"{depth_mb:.1f} MB moved a step, {depth_ms:.4f} ms by CUDA events ({card})")
    summary["s"] = time.perf_counter() - t_phase
    print(f"[parallel] phase 20 in {summary['s']:.1f} s (the ranks {ranks_s:.1f} s)")
    return summary, launches


# --------------------------------------------------------------------------
# phase 21: GCBC, the deterministic decoder, the state-only family and the
# auxiliary losses at full width
# --------------------------------------------------------------------------

# hulc's BC-Z, MIA and state-reconstruction losses on (the state decoder
# regresses a proprio input, which hulc takes only with these overrides)
AUX_OVERRIDES = ("state_recons=true", "perceptual_encoder.use_state_decoder=true", "perceptual_encoder.proprio=default",
                 "use_bc_z_auxiliary_loss=true", "use_mia_auxiliary_loss=true")
# name: (preset, overrides); the first four take the whole path, the others a
# train step and a policy step, each against the plain path
VARIANTS = {
    "gcbc": ("gcbc", ()),
    "hulc_deterministic": ("hulc_deterministic", ()),
    "hulc_deterministic_mlp": ("hulc_deterministic", ("action_decoder.rnn_cell=mlp",)),
    "hulc_state_only": ("hulc_state_only", ()),
    "fetch_state": ("fetch_state", ()),
    "fetch_vision": ("fetch_vision", ()),
    "hulc_aux": ("hulc", AUX_OVERRIDES),
}
VARIANTS_WHOLE_PATH = ("gcbc", "hulc_deterministic", "hulc_deterministic_mlp", "hulc_state_only")
VARIANT_EXPORTS = ("gcbc", "hulc_deterministic_mlp")  # served by one process without model code
# JAX's init's parameter counts (tests/test_torch_variants.py holds the port's to JAX's)
VARIANT_PARAMS = {"gcbc": 29_939_447, "hulc_deterministic": 46_694_984, "hulc_deterministic_mlp": 42_498_632,
                  "hulc_state_only": 43_547_910, "fetch_state": 26_792_086, "fetch_vision": 27_934_950,
                  "hulc_aux": 49_537_504}
VARIANT_TRAIN_STEPS = 3  # two warm-ups and one timed
VARIANT_POLICY_STEPS = 4  # single-lane and lockstep steps held against the plain path
VARIANT_EVAL_CHAINS, VARIANT_EVAL_EP_LEN = 64, 30  # gcbc's short evaluate_policy_batched pass
VARIANT_SERVE_STEPS = 4  # the served language episode and lockstep steps


def variant_config(name):
    from hulc_tpu_torch.config import apply_overrides, get_config

    preset, overrides = VARIANTS[name]
    return apply_overrides(get_config(preset), list(overrides))


def variant_step_launches(cfg):
    """Each kernel's launches in one train step of ``cfg``: B.1' per camera,
    B.2 and B.2' per SpatialSoftmax camera, B.3' with the logistic decoder,
    B.4 with a discrete plan (GCBC has none), B.6 per layer of the relu RNN
    cell (the mlp cell has no recurrence), B.5 and B.7 once; every other
    kernel 0."""
    from hulc_tpu_torch import kernels

    pe, ad = cfg.perceptual_encoder, cfg.action_decoder
    cams = [c for c in (pe.rgb_static, pe.rgb_gripper) if c is not None]
    ss = sum(c.kind == "spatial_softmax" for c in cams)
    logistic = int(ad.kind == "logistic")
    plan = int(cfg.model_kind != "gcbc" and cfg.distribution.kind == "discrete")
    rnn = ad.num_layers if ad.rnn_cell == "rnn" else 0
    on = {"hulc_preprocess_rgb_shift": sum(c.shift_pad > 0 for c in cams), "hulc_spatial_softmax": ss,
          "hulc_spatial_softmax_bwd": ss, "hulc_mixture_nll_fwd": logistic, "hulc_mixture_nll_bwd": logistic,
          "hulc_plan_st_kl_fwd": plan, "hulc_plan_st_kl_bwd": plan, "hulc_rnn_relu_fwd": rnn,
          "hulc_rnn_relu_bwd": rnn, "hulc_adam_lowp": 1, "hulc_grad_norm_finish": 1}
    return {k.symbol: on.get(k.symbol, 0) for k in kernels.ALL_KERNELS}


def variant_path_kernels(cfg):
    """The kernels the variant's path (train, val and policy steps) must
    launch; every other kernel must launch none: the train step's
    (``variant_step_launches``) and the policy's, B.1 with a camera and B.3
    with the logistic decoder."""
    pe = cfg.perceptual_encoder
    on = {k for k, n in variant_step_launches(cfg).items() if n}
    if pe.rgb_static is not None or pe.rgb_gripper is not None:
        on.add("hulc_preprocess_rgb")
    if cfg.action_decoder.kind == "logistic":
        on.add("hulc_logistic_mixture_sample")
    return on


def check_variant_launches(name, cfg, launches):
    on = variant_path_kernels(cfg)
    missing = sorted(k for k in on if not launches[k] > 0)
    extra = sorted(k for k, n in launches.items() if n and k not in on)
    if missing or extra:
        fail(f"{name}: the path never launched {missing}, or launched {extra}, which it must not: {launches}")


def check_fetch_vision_kernels(seed):
    """B.1', B.2 and B.2' at fetch_vision's shapes (its 84 px static camera
    at the train step's 2B x S frames, pad 4; the 7 x 7 map its tower gives
    there), against their plain versions. Returns the largest errors."""
    from hulc_tpu_torch.ops.image_ops import draw_shifts
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ

    cfg = variant_config("fetch_vision")
    enc = cfg.perceptual_encoder.rgb_static
    gen = torch.Generator(device="cuda").manual_seed(seed + 71)
    n = 2 * BATCH_PER_MOD * SEQ
    imgs = torch.randint(0, 256, (2 * BATCH_PER_MOD, SEQ, enc.input_size, enc.input_size, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    check_shift(imgs, draw_shifts(n, enc.shift_pad, gen, "cuda"), enc.shift_pad, "fetch_vision's camera")
    side = ((enc.input_size - 8) // 4 + 1 - 4) // 2 + 1 - 2  # the conv tower: 8x8 s4, 4x4 s2, 3x3 s1
    conv_map = torch.randn((n, 64, side, side), generator=gen, device="cuda")
    fwd = check_ss_fwd(conv_map, "fetch_vision's map")
    dx, dt = check_ss_bwd(conv_map, torch.randn((n, 128), generator=gen, device="cuda"), "fetch_vision's map")
    print(f"[variants] at fetch_vision's shapes: the shift kernel (B.1') bit-equal at {tuple(imgs.shape)}, pad "
          f"{enc.shift_pad}; SpatialSoftmax forward (B.2) max abs err {fwd:.3g}, backward (B.2') dx {dx:.3g}, dT "
          f"relative {dt:.3g} at {tuple(conv_map.shape)}")
    return {"preprocess_rgb_shift": 0.0, "spatial_softmax": fwd, "spatial_softmax_bwd": dx}


def run_variant(name, seed, lanes, card):
    """One variant at full width: train steps with each kernel's launches per
    step, and a policy at 1 lane (and, on the whole path, a val step, the
    policy at ``lanes`` lanes and for GCBC a short evaluator pass), each
    against the plain path. Returns (summary, launches, (cfg, model))."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
    from hulc_tpu_torch.evaluation.eval_split import run_batched
    from hulc_tpu_torch.models import make_model
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ, synthetic_fused_batch
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    whole = name in VARIANTS_WHOLE_PATH
    cfg = variant_config(name)
    pe, ad = cfg.perceptual_encoder, cfg.action_decoder
    model = make_model(cfg, "cuda", seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != VARIANT_PARAMS[name]:
        fail(f"{name}: {n_params} parameters, JAX's init has {VARIANT_PARAMS[name]}")
    if (model.plan_proposal is None) != (cfg.model_kind == "gcbc"):
        fail(f"{name}: a GCBC model has no plan proposal, any other one has")
    batch = synthetic_fused_batch(cfg, BATCH_PER_MOD, SEQ, seed, "cuda")
    rng = np.random.default_rng(seed + 61)
    steps = VARIANT_POLICY_STEPS if whole else 1
    lang = rng.normal(size=cfg.lang_dim).astype(np.float32)
    single_obs = make_obs(rng, cfg, steps)
    langs = rng.normal(size=(lanes, cfg.lang_dim)).astype(np.float32)
    batched_obs = [make_obs(rng, cfg, lanes) for _ in range(steps)] if whole else None

    # the main path
    trainer = Trainer(cfg, TrainerConfig(seed=seed), "cuda")
    trainer.model.load_state_dict(model.state_dict())
    trainer.init_state(1)
    train_steps = VARIANT_TRAIN_STEPS if whole else 1
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step_losses, host, events = drive_training(trainer, batch, cfg.loss.kl_beta, train_steps)
    per_step = launch_counts()
    want = {k: n * train_steps for k, n in variant_step_launches(cfg).items()}
    if per_step != want:
        fail(f"{name}: {train_steps} train steps launched {({k: v for k, v in per_step.items() if v})}, expected "
             f"{({k: v for k, v in want.items() if v})} and no other kernel")
    for i, losses in enumerate(step_losses):
        if not all(np.isfinite(v) for v in losses.values()):
            fail(f"{name} train step {i}: a loss is not finite: {losses}")
    aux_keys = [k for on, k in ((cfg.state_recons, "proprio_loss"), (cfg.use_bc_z_auxiliary_loss, "lang_pred_loss"),
                                (cfg.use_mia_auxiliary_loss, "lang_contrastive_loss")) if on]
    if any(not step_losses[0][k] > 0.0 for k in aux_keys) or (cfg.model_kind == "gcbc") != (
            step_losses[0]["kl_loss"] == 0.0):
        fail(f"{name}: the auxiliary losses {aux_keys} must be positive, the KL zero exactly for GCBC: {step_losses[0]}")
    val = None
    if whole:
        trainer.model.eval()
        with torch.no_grad():
            val = trainer.val_step(split_fused(batch), cfg.loss.kl_beta,
                                   generator=torch.Generator(device="cuda").manual_seed(seed))
        trainer.model.train()
        if not all(np.isfinite(float(v)) for v in val.values()):
            fail(f"{name} val step: a metric is not finite: {val}")
    single_actions, single_states = drive_single(cfg, model, single_obs, lang, seed)
    if whole:
        batched_actions, batched_states = drive_batched(cfg, model, batched_obs, langs, seed)
    evaluator = None
    if name == "gcbc":
        with tempfile.TemporaryDirectory() as tmp:
            evaluator, _, _ = run_batched(cfg, BatchedHulcPolicy(cfg, model, lanes, seed=seed), VARIANT_EVAL_CHAINS,
                                          VARIANT_EVAL_EP_LEN, seed, tmp)
    torch.cuda.synchronize()
    launches = launch_counts()
    check_variant_launches(name, cfg, launches)
    del trainer
    sampled_gripper = ad.kind == "logistic" and ad.discrete_gripper
    check_actions(f"{name} single lane", single_actions, 1, discrete_gripper=sampled_gripper)
    if whole:
        check_actions(f"{name} batched", batched_actions, lanes, discrete_gripper=sampled_gripper)
    step_ms, event_ms_ = statistics.median(host[2:] or host), statistics.median(events[2:] or events)
    print(f"[timing] {name} train step (2B={2 * BATCH_PER_MOD}, S={SEQ}, {'median after 2 warm-ups' if whole else 'the first'}): "
          f"host clock {step_ms:.4f} ms, CUDA events {event_ms_:.4f} ms; all steps host {[round(t, 4) for t in host]} ms, "
          f"events {[round(t, 4) for t in events]} ms ({card})")
    if evaluator is not None:
        print(f"[variants] gcbc evaluate_policy_batched: {evaluator['lanes']} lanes, {evaluator['chains']} chains, "
              f"ep_len {evaluator['ep_len']}: {evaluator['lockstep_iters']} lockstep iterations, {evaluator['env_steps']} "
              f"env steps in {evaluator['wall_s']:.4f} s, avg_seq_len {evaluator['results']['avg_seq_len']} ({card})")

    # the main path against the plain path
    train_check = compare_train_plain(cfg, model, batch, seed, label=f"{name} train plain path")
    val_check = None
    if whole:
        val_trainer = Trainer(cfg, TrainerConfig(seed=seed), "cuda")
        val_trainer.model.load_state_dict(model.state_dict())
        val_check = compare_val_plain(cfg, val_trainer, seed, split_fused(batch), label=name)
        del val_trainer
    plain_model = make_model(cfg, "cuda", seed=seed, use_kernels=False)
    plain_model.load_state_dict(model.state_dict())
    p_actions, p_plans = plain_single(cfg, plain_model, single_obs, lang, seed, single_states)
    k_plans = np.stack([st.plan[0].cpu().numpy() for st in single_states[1:]])
    replanned = np.array([t % cfg.replan_freq == 0 for t in range(steps)])
    policy_err = {"1": compare_plain(f"{name} single lane", single_actions, p_actions, k_plans, p_plans, replanned,
                                     cfg)}
    if whole:
        masks = [replan_mask(t, lanes, cfg.replan_freq) for t in range(steps)]
        p_actions, p_plans = plain_batched(
            cfg, plain_model, list(zip(batched_obs, [langs] * steps, batched_states, masks)), seed)
        k_plans = np.stack([st[0].cpu().numpy() for st in batched_states[1:]])
        policy_err[str(lanes)] = compare_plain(f"{name} batched, {lanes} lanes", batched_actions, p_actions, k_plans,
                                               p_plans, np.stack(masks), cfg)
    del plain_model
    torch.cuda.empty_cache()
    summary = {"parameters": n_params, "train_step": {"host_ms": step_ms, "event_ms": event_ms_, "steps_host_ms": host,
                                                      "steps_event_ms": events, "plain_path": train_check},
               "train_launches_per_step": {k: v for k, v in variant_step_launches(cfg).items() if v},
               "losses": step_losses[-1], "val_step": val_check, "policy_plain_max_abs_err": policy_err,
               "s": time.perf_counter() - t0}
    if evaluator is not None:
        summary["evaluator"] = {k: evaluator[k] for k in ("lanes", "chains", "ep_len", "lockstep_iters", "env_steps",
                                                          "env_steps_per_s", "wall_s")}
    print(f"[variants] {name}: {n_params} parameters (JAX's), the path in {summary['s']:.1f} s ({card})")
    return summary, launches, (cfg, model)


def run_phase21(seed, lanes, card):
    """Phase 21. Returns (summary, {kernel symbol: launches on the phase's
    main paths}, {row: max abs err})."""
    t0 = time.perf_counter()
    errs = check_fetch_vision_kernels(seed)
    summary, launches, exports = {}, collections.Counter(), {}
    for name in VARIANTS:
        summary[name], n, (cfg, model) = run_variant(name, seed, lanes, card)
        launches.update(n)
        if name in VARIANT_EXPORTS:
            exports[name] = (cfg, model, variant_path_kernels(cfg) & set(SERVING_KERNELS))
        del model
    rng = np.random.default_rng(seed + 67)
    cfg = exports[VARIANT_EXPORTS[0]][0]
    lang = rng.normal(size=cfg.lang_dim).astype(np.float32)
    langs = rng.normal(size=(lanes, cfg.lang_dim)).astype(np.float32)
    summary["served"], served = run_serving_export(
        exports, seed, lanes, make_obs(rng, cfg, VARIANT_SERVE_STEPS), lang,
        [make_obs(rng, cfg, lanes) for _ in range(VARIANT_SERVE_STEPS)], langs, card, with_debug=False)
    launches.update(served)
    del exports
    torch.cuda.empty_cache()
    summary["s"] = time.perf_counter() - t0
    summary["card"] = card
    print(f"[variants] phase 21 in {summary['s']:.1f} s: "
          + ", ".join(f"{k} step {summary[k]['train_step']['host_ms']:.4f} ms" for k in VARIANTS) + f" ({card})")
    return summary, launches, errs


# --------------------------------------------------------------------------
# 22. the frozen CLIP and tactile encoders, the resize and B.15
# --------------------------------------------------------------------------

B15_TOL = 2e-4  # pixel values: the resize against its plain version (the CPU tests' tolerance against JAX)
B15_FLIP_SHARE = 1e-3  # share of elements whose bf16 rounding may fall the other way
B15_TIMED = 20  # launches a timing


def b15_modes(n):
    """(name, frames' (N, H, W, C), [FramePrep], out dtype) of every mode B.15 runs on a path: the CLIP
    and the tactile branches at ``n`` frames, training and evaluation, fp32 and bf16 out; the tactile
    160 x 120 frame's one launch (its first resize to 64 in ``FramePrep.pre``); a resized CNN camera
    (84 -> 200, unrounded)."""
    from hulc_tpu_torch.ops.image_ops import clip_prep, rgb_prep, tactile_prep

    out = []
    for train in (True, False):
        tag = "train" if train else "val"
        for dtype in (torch.float32, torch.bfloat16):
            dt = "fp32" if dtype == torch.float32 else "bf16"
            out.append((f"clip_{tag}_{dt}", (n, 200, 200, 3), [clip_prep(224, (200, 200), 10, train)], dtype))
            out.append((f"tactile_160x120_{tag}_{dt}", (n, 160, 120, 6), [tactile_prep(64, 6, train, (160, 120))],
                        dtype))
            out.append((f"tactile_64_{tag}_{dt}", (n, 64, 64, 6), [tactile_prep(64, 6, train)], dtype))
        out.append((f"rgb_84_to_200_{tag}_fp32", (n // 8, 84, 84, 3), [rgb_prep(200, (84, 84), 3, 10, train)],
                    torch.float32))
    return out


def b15_chain(frames, stages, shifts, dtype, kernel):
    """The frames through a mode's stages: B.15's launches (``kernel``) or their plain versions."""
    from hulc_tpu_torch.ops import image_ops

    x = frames
    for st in stages:
        x = (image_ops.resize_preprocess if kernel else image_ops.resize_preprocess_plain)(x, st, shifts, dtype)
    return x


def check_b15_mode(name, shape, stages, dtype, gen):
    """One mode of B.15 against its plain version: each output within the
    plain epilogue of the plain resize's value -+ B15_TOL pixel values (so a
    bf16 rounding can fall the other way only at a rounding boundary, by one
    bf16 step), and the share of elements that differ from the plain output
    at most B15_FLIP_SHARE; a mode with a first resize also checks B.15's
    raw mode (``resize_bilinear``) on that resize, its other callers' path.
    Returns (largest |kernel - plain|, flip share)."""
    from hulc_tpu_torch.ops import image_ops

    frames = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)
    prep = stages[-1]
    shifts = None
    if prep.pad:
        shifts = torch.randint(0, 2 * prep.pad + 1, (shape[0], 2), generator=gen, device="cuda", dtype=torch.int32)
    got = b15_chain(frames, stages, shifts, dtype, kernel=True)
    torch.cuda.synchronize()
    # the plain resized value at every place of the last stage's frame, and the plain epilogue around it
    resized = frames if prep.pre is None else image_ops.resize_bilinear_plain(frames, *prep.pre)
    value = image_ops.resize_bilinear_plain(resized, *prep.size)
    ident = dataclasses.replace(prep, size=tuple(value.shape[1:3]), pre=None)
    want = image_ops.resize_preprocess_plain(value, ident, shifts, dtype)
    lo = image_ops.resize_preprocess_plain(value - B15_TOL, ident, shifts, dtype)
    hi = image_ops.resize_preprocess_plain(value + B15_TOL, ident, shifts, dtype)
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"B.15 {name}: {tuple(got.shape)} {got.dtype}, the plain version {tuple(want.shape)} {want.dtype}")
    outside = int(((got < lo) | (got > hi)).sum())
    flips = float((got != want).float().mean())
    err = max_abs(got, want)
    if outside or not flips <= B15_FLIP_SHARE or not torch.isfinite(got.float()).all():
        fail(f"B.15 {name}: {outside} outputs outside the plain epilogue of the plain resize -+ {B15_TOL}, flip "
             f"share {flips:.3g} (at most {B15_FLIP_SHARE}), max abs err {err:.3g}")
    if prep.pre is not None:  # the raw launch alone
        raw = image_ops.resize_bilinear(frames, *prep.pre)
        raw_err = max_abs(raw, resized)
        if not raw_err <= B15_TOL:
            fail(f"B.15 {name}: the raw resize is {raw_err:.3g} off its plain version (at most {B15_TOL})")
    return err, flips


def b15_bytes(shape, stages, dtype):
    """Bytes the mode must move: the uint8 frames read once and its output written once."""
    n, h, w, c = shape
    oh, ow = stages[-1].out_size
    return n * h * w * c + n * c * oh * ow * (4 if dtype == torch.float32 else 2)


def time_b15(name, shape, stages, dtype, gen):
    """Device ms (CUDA events) of the mode's launches, of its plain version,
    of ``F.interpolate(antialias=True)`` of the resize alone on the same
    frames as float NCHW (the nearest library call: no one call computes the
    whole function), and the mode's bound."""
    import torch.nn.functional as F

    frames = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)
    prep = stages[-1]
    shifts = None
    if prep.pad:
        shifts = torch.randint(0, 2 * prep.pad + 1, (shape[0], 2), generator=gen, device="cuda", dtype=torch.int32)
    ms = time_events(lambda: b15_chain(frames, stages, shifts, dtype, kernel=True), B15_TIMED)
    plain_ms = time_events(lambda: b15_chain(frames, stages, shifts, dtype, kernel=False), 3)
    nchw = frames.permute(0, 3, 1, 2).float().contiguous()
    size = prep.pre or prep.size
    library_ms = time_events(lambda: F.interpolate(nchw, size=size, mode="bilinear", antialias=True,
                                                   align_corners=False), B15_TIMED)
    del nchw
    bound_ms, bound_by = bound(b15_bytes(shape, stages, dtype), 0.0)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "library_call": "F.interpolate(antialias=True), "
            "the resize alone", "bound_ms": bound_ms, "bound_by": bound_by, "shape": list(shape),
            "launches_per_call": len(stages)}


def check_b15(seed, card):
    """B.15 against its plain version in every mode at the training step's
    2B x S frames and validation's B x S, and its times at the training
    shapes. Returns ({mode: (err, flips)}, {mode: timing})."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ

    gen = torch.Generator(device="cuda").manual_seed(seed + 221)
    results, timing = {}, {}
    for n, where in ((2 * BATCH_PER_MOD * SEQ, "train shape"), (BATCH_PER_MOD * SEQ, "val shape")):
        for name, shape, stages, dtype in b15_modes(n):
            before = kernels.RESIZE_PREPROCESS.launches
            err, flips = check_b15_mode(f"{name} at the {where}", shape, stages, dtype, gen)
            raw_checks = sum(st.pre is not None for st in stages)
            if kernels.RESIZE_PREPROCESS.launches - before != len(stages) + raw_checks:
                fail(f"B.15 {name}: {kernels.RESIZE_PREPROCESS.launches - before} launches for {len(stages)} "
                     f"stage(s) and {raw_checks} raw check(s)")
            results[f"{name}@{n}"] = {"max_abs_err": err, "flip_share": flips}
            print(f"[b15] {name} at {shape} ({where}): max abs err {err:.3g}, flip share {flips:.3g}")
            torch.cuda.empty_cache()
    n = 2 * BATCH_PER_MOD * SEQ
    for name, shape, stages, dtype in b15_modes(n):
        if name in ("clip_train_fp32", "clip_train_bf16", "clip_val_fp32", "tactile_160x120_train_fp32",
                    "tactile_64_train_fp32"):
            t = timing[name] = time_b15(name, shape, stages, dtype, gen)
            print(f"[timing] B.15 {name} at {shape}: kernel {t['ms']:.6f} ms ({t['launches_per_call']} launch(es)), "
                  f"plain {t['plain_ms']:.6f} ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']}, "
                  f"{100 * t['bound_ms'] / t['ms']:.1f}% of it), F.interpolate(antialias=True) of the resize alone "
                  f"{t['library_ms']:.6f} ms ({card})")
            torch.cuda.empty_cache()
    return results, timing


# JAX's init's parameter counts, the tactile frame and 1024-d language in its batch
# (tests/test_torch_encoder_presets.py holds the port's to JAX's)
ENCODER_PARAMS = {"hulc_clip_vision": 85_806_391, "hulc_clip_vision_bf16": 85_806_391,
                  "hulc_clip_vision_vit": 134_875_607, "hulc_tactile": 58_351_895, "hulc_clip_lang": 48_364_279}
ENCODERS = {  # name: (preset, overrides); the ViT takes a train step and nothing else
    "hulc_clip_vision": ("hulc_clip_vision", ()),
    "hulc_clip_vision_bf16": ("hulc_clip_vision", ("compute_dtype=bfloat16",)),
    "hulc_clip_vision_vit": ("hulc_clip_vision", ("perceptual_encoder.rgb_static.clip_model=ViT-B/32",)),
    "hulc_tactile": ("hulc_tactile", ()),
    "hulc_clip_lang": ("hulc_clip_lang", ()),
}
ENCODER_TRAIN_STEPS = 3  # two warm-ups and one timed
ENCODER_PATTERNS = 4  # noise patterns of the plain-path checks of the long CLIP / tactile steps
ENCODER_POLICY_STEPS = 4
ENCODER_EVAL_CHAINS, ENCODER_EVAL_EP_LEN = 64, 30  # hulc_clip_lang's short evaluate_policy_batched pass
ENCODER_FIT_STEPS, ENCODER_FIT_EPOCHS, ENCODER_FIT_VAL_BATCHES = 2, 2, 1
ENCODER_CLI_STEPS = 2
ENCODER_BESIDE_WARMUPS, ENCODER_BESIDE_STEPS = 2, 5  # hulc_clip_lang's train step and hulc's, in turn


def encoder_config(name):
    from hulc_tpu_torch.config import apply_overrides, get_config

    preset, overrides = ENCODERS[name]
    return apply_overrides(get_config(preset), list(overrides))


def encoder_step_launches(cfg):
    """Each kernel's launches in one train step of ``cfg`` on synthetic frames
    (a CLIP camera's at 200 px, a tactile tower's at 160 x 120): B.15 once
    for a CLIP camera and once for a tactile tower (its two resizes in one
    launch); B.1' per CNN camera and B.2 / B.2' per SpatialSoftmax camera
    (their bf16 instances in a bf16 model); B.3', B.4, B.6 per layer, B.5
    and B.7. Every other kernel 0."""
    from hulc_tpu_torch import kernels

    pe = cfg.perceptual_encoder
    cams = [c for c in (pe.rgb_static, pe.rgb_gripper) if c is not None]
    cnn = [c for c in cams if c.kind in ("spatial_softmax", "nature_cnn")]
    ss = sum(c.kind == "spatial_softmax" for c in cams)
    sfx = "_bf16" if cfg.compute_dtype == "bfloat16" else ""
    on = {"hulc_resize_preprocess": sum(c.kind == "clip" for c in cams) + (pe.tactile is not None),
          f"hulc_preprocess_rgb_shift{sfx}": sum(c.shift_pad > 0 for c in cnn), f"hulc_spatial_softmax{sfx}": ss,
          f"hulc_spatial_softmax_bwd{sfx}": ss, "hulc_mixture_nll_fwd": 1, "hulc_mixture_nll_bwd": 1,
          "hulc_plan_st_kl_fwd": 1, "hulc_plan_st_kl_bwd": 1, "hulc_rnn_relu_fwd": cfg.action_decoder.num_layers,
          "hulc_rnn_relu_bwd": cfg.action_decoder.num_layers, "hulc_adam_lowp": 1, "hulc_grad_norm_finish": 1}
    return {k.symbol: on.get(k.symbol, 0) for k in kernels.ALL_KERNELS}


def encoder_path_kernels(cfg):
    """The kernels a preset's path must launch, and the only ones it may:
    the train step's, and in validation (and the policies) B.1 per CNN
    camera, B.3 and the training kernels' forwards."""
    sfx = "_bf16" if cfg.compute_dtype == "bfloat16" else ""
    on = {k for k, n in encoder_step_launches(cfg).items() if n}
    pe = cfg.perceptual_encoder
    if any(c is not None and c.kind in ("spatial_softmax", "nature_cnn") for c in (pe.rgb_static, pe.rgb_gripper)):
        on.add(f"hulc_preprocess_rgb{sfx}")
    on.add("hulc_logistic_mixture_sample")
    return on


def check_encoder_launches(name, cfg, launches):
    on = encoder_path_kernels(cfg)
    missing = sorted(k for k in on if not launches[k] > 0)
    extra = sorted(k for k, n in launches.items() if n and k not in on)
    if missing or extra:
        fail(f"{name}: the path never launched {missing}, or launched {extra}, which it must not: "
             f"{({k: n for k, n in launches.items() if n})}")


def run_encoder_fit(cfg, seed, card):
    """``Trainer.fit`` of ``hulc_clip_vision`` on a 200 / 84 px fixture
    (frames resized to 224 on the device): ENCODER_FIT_EPOCHS epochs of
    ENCODER_FIT_STEPS steps with validation and checkpoints; then the train
    CLI, ``--config hulc_clip_vision --fixture``, for ENCODER_CLI_STEPS steps.
    Returns (report, {kernel symbol: launches})."""
    from hulc_tpu_torch.data.fixtures import make_fixture_dataset
    from hulc_tpu_torch.data.loader import make_loaders
    from hulc_tpu_torch.training import train
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    before = collections.Counter(launch_counts())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        root = make_fixture_dataset(tmp / "data", num_episodes=FIT_EPISODES, episode_len=FIT_EPISODE_LEN,
                                    small=False, seed=seed)
        loader = make_loaders(cfg, root, batch_size=FIT_BATCH, fuse=True, seed=seed, num_workers=1)
        val = make_loaders(cfg, root, split="validation", batch_size=FIT_BATCH, deterministic=True)
        host = loader._make()["fused"]
        if host.rgb_static.shape[2:] != (200, 200, 3):
            fail(f"the clip fixture's static frames are {host.rgb_static.shape}, not the dataset's 200 px")
        trainer = Trainer(cfg, TrainerConfig(run_dir=str(tmp / "run"), seed=seed, log_every=1,
                                             val_max_batches=ENCODER_FIT_VAL_BATCHES), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = trainer.fit(FirstBatches(loader, ENCODER_FIT_STEPS), val, max_epochs=ENCODER_FIT_EPOCHS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        records = [json.loads(line) for line in (tmp / "run" / "metrics.jsonl").read_text().splitlines()]
        if steps != ENCODER_FIT_STEPS * ENCODER_FIT_EPOCHS or {r["prefix"] for r in records} != {"train", "val",
                                                                                                 "epoch"}:
            fail(f"hulc_clip_vision fit: {steps} steps, prefixes {sorted({r['prefix'] for r in records})}")
        if not all(np.isfinite(v) for r in records for k, v in r.items() if k != "prefix"):
            fail("hulc_clip_vision fit: a value in metrics.jsonl is not finite")
        del trainer, loader, val
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cli = train.main(["--config", "hulc_clip_vision", "--fixture", "--run-dir", str(tmp / "cli"), "--seed",
                          str(seed), "--steps", str(ENCODER_CLI_STEPS), "--batch-size", "8", "--val-max-batches", "1"])
        cli_s = time.perf_counter() - t0
        if cli.step != ENCODER_CLI_STEPS:
            fail(f"train.py --config hulc_clip_vision took {cli.step} steps, not {ENCODER_CLI_STEPS}")
        del cli
    torch.cuda.empty_cache()
    launches = collections.Counter(launch_counts())
    launches.subtract(before)
    report = {"fit_steps": steps, "fit_s": fit_s, "cli_steps": ENCODER_CLI_STEPS, "cli_s": cli_s}
    print(f"[encoders] hulc_clip_vision fit on a 200 / 84 px fixture (2 x {FIT_BATCH} windows a step): {steps} steps "
          f"with validation and checkpoints in {fit_s:.2f} s; train.py --config hulc_clip_vision --fixture "
          f"--steps {ENCODER_CLI_STEPS} in {cli_s:.2f} s ({card})")
    return report, dict(launches)


def run_encoder(name, seed, lanes, card):
    """One preset at full width: ENCODER_TRAIN_STEPS train steps on the fused
    batch with each kernel's launches per step exact, one on the
    {"vis", "lang"} batch, a val step, and (``hulc_clip_lang``)
    the policies at 1 and ``lanes`` lanes and a short batched evaluator
    pass; then each against the plain path (the ViT: one train step alone).
    Returns (summary, launches, (cfg, model))."""
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
    from hulc_tpu_torch.evaluation.eval_split import run_batched
    from hulc_tpu_torch.models import make_model
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ, synthetic_fused_batch
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    cfg = encoder_config(name)
    whole, served = name != "hulc_clip_vision_vit", name == "hulc_clip_lang"
    model = make_model(cfg, "cuda", seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != ENCODER_PARAMS[name]:
        fail(f"{name}: {n_params} parameters, JAX's init has {ENCODER_PARAMS[name]}")
    batch = synthetic_fused_batch(cfg, BATCH_PER_MOD, SEQ, seed, "cuda")

    # the main path
    trainer = Trainer(cfg, TrainerConfig(seed=seed), "cuda")
    trainer.model.load_state_dict(model.state_dict())
    trainer.init_state(1)
    steps = ENCODER_TRAIN_STEPS if whole else 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    step_losses, host, events = drive_training(trainer, batch, cfg.loss.kl_beta, steps)
    per_step = launch_counts()
    want = {k: n * steps for k, n in encoder_step_launches(cfg).items()}
    if per_step != want:
        fail(f"{name}: {steps} train steps launched {({k: v for k, v in per_step.items() if v})}, expected "
             f"{({k: v for k, v in want.items() if v})} and no other kernel")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, losses in enumerate(step_losses):
        if not all(np.isfinite(v) for v in losses.values()):
            fail(f"{name} train step {i}: a loss is not finite: {losses}")
    frozen = [p for p in trainer.model.frozen_parameters()]
    if (cfg.perceptual_encoder.tactile is not None or cfg.perceptual_encoder.rgb_static.kind == "clip") != bool(frozen):
        fail(f"{name}: {len(frozen)} frozen parameters")
    if frozen and not all(p.grad is not None and not p.grad.any() for p in frozen):
        fail(f"{name}: a frozen backbone parameter took a gradient that is not zero")
    split = None
    if whole:  # the per-modality schema: a {"vis", "lang"} batch, a pass each
        split = {k: float(v) for k, v in trainer.train_step(split_fused(batch), cfg.loss.kl_beta).items()}
        if not all(np.isfinite(v) for v in split.values()):
            fail(f"{name} {{vis, lang}} train step: a loss is not finite: {split}")
    val = None
    rng = np.random.default_rng(seed + 227)
    if whole:
        trainer.model.eval()
        with torch.no_grad():
            val = trainer.val_step(split_fused(batch), cfg.loss.kl_beta,
                                   generator=torch.Generator(device="cuda").manual_seed(seed))
        trainer.model.train()
        if not all(np.isfinite(float(v)) for v in val.values()):
            fail(f"{name} val step: a metric is not finite: {val}")
    if served:
        lang = rng.normal(size=cfg.lang_dim).astype(np.float32)
        langs = rng.normal(size=(lanes, cfg.lang_dim)).astype(np.float32)
        single_obs = make_obs(rng, cfg, ENCODER_POLICY_STEPS)
        batched_obs = [make_obs(rng, cfg, lanes) for _ in range(ENCODER_POLICY_STEPS)]
        single_actions, single_states = drive_single(cfg, model, single_obs, lang, seed)
        batched_actions, batched_states = drive_batched(cfg, model, batched_obs, langs, seed)
        with tempfile.TemporaryDirectory() as tmp:
            evaluator, _, _ = run_batched(cfg, BatchedHulcPolicy(cfg, model, lanes, seed=seed), ENCODER_EVAL_CHAINS,
                                          ENCODER_EVAL_EP_LEN, seed, tmp)
    torch.cuda.synchronize()
    launches = launch_counts()
    if whole:
        check_encoder_launches(name, cfg, launches)
    del trainer
    step_ms, event_ms_ = statistics.median(host[2:] or host), statistics.median(events[2:] or events)
    print(f"[timing] {name} train step (2B={2 * BATCH_PER_MOD}, S={SEQ}, "
          f"{'median after 2 warm-ups' if whole else 'the first'}): host clock {step_ms:.4f} ms, CUDA events "
          f"{event_ms_:.4f} ms; all steps host {[round(t, 4) for t in host]} ms, events {[round(t, 4) for t in events]} "
          f"ms; peak memory {peak_gb:.2f} GB ({card})")
    summary = {"parameters": n_params, "train_step": {"host_ms": step_ms, "event_ms": event_ms_, "steps_host_ms": host,
                                                      "steps_event_ms": events, "peak_memory_gb": peak_gb},
               "train_launches_per_step": {k: v for k, v in encoder_step_launches(cfg).items() if v},
               "losses": step_losses[-1], "split_step_losses": split}
    if served:
        check_actions(f"{name} single lane", single_actions, 1)
        check_actions(f"{name} batched", batched_actions, lanes)
        summary["evaluator"] = {k: evaluator[k] for k in ("lanes", "chains", "ep_len", "lockstep_iters", "env_steps",
                                                          "env_steps_per_s", "wall_s")}
        print(f"[encoders] {name} evaluate_policy_batched: {evaluator['lanes']} lanes, {evaluator['chains']} chains, "
              f"ep_len {evaluator['ep_len']}: {evaluator['env_steps']} env steps in {evaluator['wall_s']:.4f} s, "
              f"avg_seq_len {evaluator['results']['avg_seq_len']} ({card})")

    # the main path against the plain path (no SpatialSoftmax in a CLIP model: no keypoint share to move)
    bf16 = cfg.compute_dtype == "bfloat16"
    summary["train_step"]["plain_path"] = compare_train_plain(
        cfg, model, batch, seed, label=f"{name} train plain path", bf16_share=0.0 if bf16 else None,
        patterns=ENCODER_PATTERNS if name != "hulc_clip_lang" else ULP_PATTERNS)
    if whole:
        val_trainer = Trainer(cfg, TrainerConfig(seed=seed), "cuda")
        val_trainer.model.load_state_dict(model.state_dict())
        summary["val_step"] = compare_val_plain(cfg, val_trainer, seed, split_fused(batch), label=name,
                                                patterns=BF16_VAL_PATTERNS if bf16 else 0, bf16_share=0.0 if bf16
                                                else None)
        del val_trainer
    if served:
        plain_model = make_model(cfg, "cuda", seed=seed, use_kernels=False)
        plain_model.load_state_dict(model.state_dict())
        p_actions, p_plans = plain_single(cfg, plain_model, single_obs, lang, seed, single_states)
        k_plans = np.stack([st.plan[0].cpu().numpy() for st in single_states[1:]])
        replanned = np.array([t % cfg.replan_freq == 0 for t in range(ENCODER_POLICY_STEPS)])
        errs = {"1": compare_plain(f"{name} single lane", single_actions, p_actions, k_plans, p_plans, replanned,
                                   cfg)}
        masks = [replan_mask(t, lanes, cfg.replan_freq) for t in range(ENCODER_POLICY_STEPS)]
        p_actions, p_plans = plain_batched(cfg, plain_model, list(zip(batched_obs, [langs] * ENCODER_POLICY_STEPS,
                                                                      batched_states, masks)), seed)
        k_plans = np.stack([st[0].cpu().numpy() for st in batched_states[1:]])
        errs[str(lanes)] = compare_plain(f"{name} batched, {lanes} lanes", batched_actions, p_actions, k_plans,
                                         p_plans, np.stack(masks), cfg)
        summary["policy_plain_max_abs_err"] = errs
        del plain_model
    torch.cuda.empty_cache()
    summary["s"] = time.perf_counter() - t0
    print(f"[encoders] {name}: {n_params} parameters (JAX's), its path in {summary['s']:.1f} s ({card})")
    return summary, launches, (cfg, model)


def time_beside_hulc(cfg, seed, card):
    """``hulc_clip_lang``'s train step (``cfg``) beside ``hulc``'s in this
    process: a trainer each on its synthetic batch, ENCODER_BESIDE_WARMUPS
    warm-up steps each, then ENCODER_BESIDE_STEPS steps each, the two
    presets in turn, each step ended by a sync. Outside the main path: its
    launches are not counted. Returns {preset: {"host_ms", "event_ms"
    (medians), "steps_host_ms", "steps_event_ms"}}."""
    from hulc_tpu_torch.config import get_config
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ, synthetic_fused_batch
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    runs = {}
    for name, c in (("hulc_clip_lang", cfg), ("hulc", get_config("hulc"))):
        trainer = Trainer(c, TrainerConfig(seed=seed), "cuda")
        trainer.init_state(1)
        runs[name] = (trainer, synthetic_fused_batch(c, BATCH_PER_MOD, SEQ, seed, "cuda"), c.loss.kl_beta)
    times = {name: ([], []) for name in runs}
    for i in range(ENCODER_BESIDE_WARMUPS + ENCODER_BESIDE_STEPS):
        for name, (trainer, batch, kl_beta) in runs.items():
            _, host, events = drive_training(trainer, batch, kl_beta, 1)
            if i >= ENCODER_BESIDE_WARMUPS:
                times[name][0].extend(host)
                times[name][1].extend(events)
    del runs
    torch.cuda.empty_cache()
    out = {name: {"host_ms": statistics.median(h), "event_ms": statistics.median(e), "steps_host_ms": h,
                  "steps_event_ms": e} for name, (h, e) in times.items()}
    print(f"[timing] hulc_clip_lang beside hulc (2B={2 * BATCH_PER_MOD}, S={SEQ}, one train step of each in turn, "
          f"median of {ENCODER_BESIDE_STEPS} after {ENCODER_BESIDE_WARMUPS} warm-ups each): "
          + "; ".join(f"{name} host clock {r['host_ms']:.4f} ms, CUDA events {r['event_ms']:.4f} ms, steps host "
                      f"{[round(t, 4) for t in r['steps_host_ms']]}" for name, r in out.items())
          + f"; hulc_clip_lang / hulc {out['hulc_clip_lang']['host_ms'] / out['hulc']['host_ms']:.4f} ({card})")
    return out


def run_phase22(seed, lanes, card):
    """Phase 22. Returns (summary, {kernel symbol: launches on the phase's
    main paths}, B.15's {mode: errors}, B.15's timings)."""
    t0 = time.perf_counter()
    b15, b15_timing = check_b15(seed, card)
    summary, launches = {"b15": b15}, collections.Counter()
    for name in ENCODERS:
        summary[name], n, (cfg, model) = run_encoder(name, seed, lanes, card)
        launches.update(n)
        if name == "hulc_clip_vision":
            summary["clip_vision_fit"], n = run_encoder_fit(cfg, seed, card)
            launches.update(n)
        elif name == "hulc_clip_lang":
            rng = np.random.default_rng(seed + 229)
            lang = rng.normal(size=cfg.lang_dim).astype(np.float32)
            langs = rng.normal(size=(lanes, cfg.lang_dim)).astype(np.float32)
            summary["served"], served = run_serving_export(
                {name: (cfg, model, SERVING_KERNELS)}, seed, lanes, make_obs(rng, cfg, VARIANT_SERVE_STEPS), lang,
                [make_obs(rng, cfg, lanes) for _ in range(VARIANT_SERVE_STEPS)], langs, card, with_debug=False)
            launches.update(served)
            summary["clip_lang_beside_hulc"] = time_beside_hulc(cfg, seed, card)
        del model
        torch.cuda.empty_cache()
    if launches["hulc_resize_preprocess"] == 0:
        fail("phase 22 never launched B.15 on its main paths")
    summary["s"] = time.perf_counter() - t0
    summary["card"] = card
    print(f"[encoders] phase 22 in {summary['s']:.1f} s: "
          + ", ".join(f"{k} step {summary[k]['train_step']['host_ms']:.4f} ms" for k in ENCODERS) + f" ({card})")
    return summary, launches, b15, b15_timing


# --------------------------------------------------------------------------


KERNEL_INFO = {
    "preprocess_rgb": ("hulc_preprocess_rgb", "hulc_tpu_torch/csrc/preprocess.cu", "hulc_tpu/ops/image_ops.py:85"),
    "spatial_softmax": ("hulc_spatial_softmax", "hulc_tpu_torch/csrc/spatial_softmax.cu", "hulc_tpu/models/vision.py:38"),
    "logistic_mixture_sample": (
        "hulc_logistic_mixture_sample", "hulc_tpu_torch/csrc/logistic_mixture.cu",
        "hulc_tpu/ops/logistic_mixture.py:114",
    ),
    "preprocess_rgb_shift": (
        "hulc_preprocess_rgb_shift", "hulc_tpu_torch/csrc/preprocess.cu", "hulc_tpu/ops/image_ops.py:27",
    ),
    "spatial_softmax_bwd": (
        "hulc_spatial_softmax_bwd", "hulc_tpu_torch/csrc/spatial_softmax.cu", "hulc_tpu/models/vision.py:38",
    ),
    "mixture_nll_fwd": (
        "hulc_mixture_nll_fwd", "hulc_tpu_torch/csrc/logistic_mixture_loss.cu",
        "hulc_tpu/ops/logistic_mixture.py:23",
    ),
    "mixture_nll_bwd": (
        "hulc_mixture_nll_bwd", "hulc_tpu_torch/csrc/logistic_mixture_loss.cu",
        "hulc_tpu/ops/logistic_mixture.py:23",
    ),
    "plan_st_kl_fwd": (
        "hulc_plan_st_kl_fwd", "hulc_tpu_torch/csrc/plan_kl.cu", "hulc_tpu/ops/plan_distributions.py:102",
    ),
    "plan_st_kl_bwd": (
        "hulc_plan_st_kl_bwd", "hulc_tpu_torch/csrc/plan_kl.cu", "hulc_tpu/ops/plan_distributions.py:102",
    ),
    "adam_lowp": ("hulc_adam_lowp", "hulc_tpu_torch/csrc/adam_lowp.cu", "hulc_tpu/training/optimizers.py:24"),
    "grad_norm": ("hulc_grad_norm_finish", "hulc_tpu_torch/csrc/adam_lowp.cu", "hulc_tpu/training/trainer.py:258"),
    "rnn_relu_fwd": ("hulc_rnn_relu_fwd", "hulc_tpu_torch/csrc/rnn.cu", "hulc_tpu/models/layers.py:233"),
    "rnn_relu_bwd": ("hulc_rnn_relu_bwd", "hulc_tpu_torch/csrc/rnn.cu", "hulc_tpu/models/layers.py:265"),
    "rnn_tanh_fwd": ("hulc_rnn_tanh_fwd", "hulc_tpu_torch/csrc/rnn.cu", "hulc_tpu/models/layers.py:238"),
    "rnn_tanh_bwd": ("hulc_rnn_tanh_bwd", "hulc_tpu_torch/csrc/rnn.cu", "hulc_tpu/models/layers.py:265"),
    # B.9: one bidirectional layer, two launches of B.8's kernel (its launches count under B.8 too)
    "birnn_tanh_fwd": ("hulc_birnn_tanh_fwd", "hulc_tpu_torch/csrc/rnn.cu", "hulc_tpu/models/layers.py:305"),
    "birnn_tanh_bwd": ("hulc_birnn_tanh_bwd", "hulc_tpu_torch/csrc/rnn.cu", "hulc_tpu/models/layers.py:305"),
    "depth_noise": ("hulc_depth_noise", "hulc_tpu_torch/csrc/depth_noise.cu", "hulc_tpu/training/preprocess.py:58"),
    "rnn_gru_fwd": ("hulc_rnn_gru_fwd", "hulc_tpu_torch/csrc/rnn_gates.cu", "hulc_tpu/models/layers.py:238"),
    "rnn_gru_bwd": ("hulc_rnn_gru_bwd", "hulc_tpu_torch/csrc/rnn_gates.cu", "hulc_tpu/models/layers.py:265"),
    "rnn_lstm_fwd": ("hulc_rnn_lstm_fwd", "hulc_tpu_torch/csrc/rnn_gates.cu", "hulc_tpu/models/layers.py:248"),
    "rnn_lstm_bwd": ("hulc_rnn_lstm_bwd", "hulc_tpu_torch/csrc/rnn_gates.cu", "hulc_tpu/models/layers.py:265"),
    # B.13: a bidirectional layer's chains of the relu and gru cells (phase 19)
    "rnn_relu_chain_fwd": ("hulc_rnn_relu_chain_fwd", "hulc_tpu_torch/csrc/rnn.cu", "hulc_tpu/models/layers.py:305"),
    "rnn_relu_chain_bwd": ("hulc_rnn_relu_chain_bwd", "hulc_tpu_torch/csrc/rnn.cu", "hulc_tpu/models/layers.py:305"),
    "rnn_gru_chain_fwd": ("hulc_rnn_gru_chain_fwd", "hulc_tpu_torch/csrc/rnn_gates.cu",
                          "hulc_tpu/models/layers.py:305"),
    "rnn_gru_chain_bwd": ("hulc_rnn_gru_chain_bwd", "hulc_tpu_torch/csrc/rnn_gates.cu",
                          "hulc_tpu/models/layers.py:305"),
    # B.14: the bf16 instances (phase 17)
    "preprocess_rgb_bf16": (
        "hulc_preprocess_rgb_bf16", "hulc_tpu_torch/csrc/preprocess.cu", "hulc_tpu/ops/image_ops.py:85",
    ),
    "preprocess_rgb_shift_bf16": (
        "hulc_preprocess_rgb_shift_bf16", "hulc_tpu_torch/csrc/preprocess.cu", "hulc_tpu/ops/image_ops.py:27",
    ),
    "spatial_softmax_bf16": (
        "hulc_spatial_softmax_bf16", "hulc_tpu_torch/csrc/spatial_softmax.cu", "hulc_tpu/models/vision.py:38",
    ),
    "spatial_softmax_bwd_bf16": (
        "hulc_spatial_softmax_bwd_bf16", "hulc_tpu_torch/csrc/spatial_softmax.cu", "hulc_tpu/models/vision.py:38",
    ),
    # B.5': the other instances of B.5's template (phase 18)
    **{name: (symbol, "hulc_tpu_torch/csrc/adam_lowp.cu", replaces)
       for name, (_, symbol, _, _, _, replaces) in OPTIMIZER_INSTANCES.items() if name != "adam_lowp"},
    # B.15: the resized cameras' preprocess, the CLIP and tactile branches of _prep_one (phase 22)
    "resize_preprocess": (
        "hulc_resize_preprocess", "hulc_tpu_torch/csrc/resize_preprocess.cu", "hulc_tpu/training/preprocess.py:21",
    ),
}


# Each kernel's other timed calls, under its row of the kernels line: the
# serving kernels at one lane, the preprocess of the gripper camera, B.2 at
# the training step's shape, B.2'' (the backward with a learnable
# temperature) and the mixture NLL forward under no_grad (the main path's
# also writes the gradients).
EXTRA_TIMINGS = {
    "preprocess_rgb": {"at_1_lane": "preprocess_rgb_1_lane", "gripper": "preprocess_rgb_gripper",
                       "gripper_at_1_lane": "preprocess_rgb_gripper_1_lane",
                       "window_shape": "preprocess_rgb_window", "gripper_window_shape": "preprocess_rgb_gripper_window"},
    "spatial_softmax": {"at_1_lane": "spatial_softmax_1_lane", "train_shape": "spatial_softmax_train"},
    "logistic_mixture_sample": {"at_1_lane": "logistic_mixture_sample_1_lane"},
    "spatial_softmax_bwd": {"learnable_t": "spatial_softmax_bwd_learnable_t"},
    "mixture_nll_fwd": {"no_grad": "mixture_nll_fwd_no_grad"},
    "rnn_relu_fwd": {"at_64_lanes": "rnn_relu_fwd_64_lanes", "at_1_lane": "rnn_relu_fwd_1_lane"},
    "rnn_relu_bwd": {"with_weight_grads": "rnn_relu_backward_all"},
    "depth_noise": {"gaussian": "depth_noise_gaussian"},
    "rnn_gru_fwd": {"at_64_lanes": "rnn_gru_fwd_64_lanes", "at_1_lane": "rnn_gru_fwd_1_lane"},
    "rnn_lstm_fwd": {"at_64_lanes": "rnn_lstm_fwd_64_lanes", "at_1_lane": "rnn_lstm_fwd_1_lane"},
    "rnn_relu_chain_fwd": {"layer": "birnn_relu_layer"},
    "rnn_gru_chain_fwd": {"layer": "birnn_gru_layer"},
    "preprocess_rgb_bf16": {"gripper": "preprocess_rgb_bf16_gripper_window"},
    "spatial_softmax_bf16": {"at_64_lanes": "spatial_softmax_bf16_64", "at_1_lane": "spatial_softmax_bf16_1"},
    "spatial_softmax_bwd_bf16": {"learnable_t": "spatial_softmax_bwd_bf16_learnable_t"},
    "resize_preprocess": {"clip_train_bf16": "b15_clip_train_bf16", "clip_val_fp32": "b15_clip_val_fp32",
                          "tactile_160x120_train_fp32": "b15_tactile_160x120_train_fp32",
                          "tactile_64_train_fp32": "b15_tactile_64_train_fp32"},
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=35)
    p.add_argument("--lanes", type=int, default=64)
    p.add_argument("--train-steps", type=int, default=5)
    p.add_argument("--serve-child", default=None, help=argparse.SUPPRESS)  # phase 13's serving process
    args = p.parse_args(argv)
    if args.serve_child:
        return serve_child(pathlib.Path(args.serve_child))
    if args.train_steps < 3:
        fail("--train-steps must be at least 3: two warm-up steps and one timed")

    t_start = time.perf_counter()  # the phases' start times go to the log, for the run's time budget
    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("CUDA is not available; this script runs the port on an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[device] TF32 off for cuDNN convolutions and cuBLAS matmuls (fp32 parity)")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    card = card_line()
    print(card)

    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.config import get_config
    from hulc_tpu_torch.data import shm_store
    from hulc_tpu_torch.models import make_model
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ, synthetic_fused_batch
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    print(f"[time] phase 2 at {time.perf_counter() - t_start:.1f} s")
    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    shm_lib = shm_store.build()
    print(f"[build] {shm_lib.name} (g++, the shm cache) in {time.perf_counter() - t0:.1f} s")
    resources = kernels.ptxas_report(lib_path.with_suffix(".log").read_text())
    for fn, r in resources.items():
        print(f"[build] {fn}: {r['registers']} registers, {r['static_smem_bytes']} B static shared memory, "
              f"{r['stack_bytes']} B stack, spills {r['spill_store_bytes']} B stored / {r['spill_load_bytes']} B loaded")

    cfg = get_config("hulc")
    model = make_model(cfg, "cuda", seed=args.seed)
    plain_model = make_model(cfg, "cuda", seed=args.seed, use_kernels=False)
    plain_model.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[model] hulc preset, {n_params} parameters, random init from seed {args.seed}")
    rng = np.random.default_rng(args.seed)
    train_batch = synthetic_fused_batch(cfg, BATCH_PER_MOD, SEQ, args.seed, "cuda")

    print(f"[time] phase 3 at {time.perf_counter() - t_start:.1f} s")
    # ---- 3. kernels against plain versions ---------------------------------
    errs = check_kernels(model, cfg, (1, args.lanes), rng)
    print(f"[kernels] serving kernels agree with their plain versions at 1 and {args.lanes} lanes: "
          + ", ".join(f"{k} max abs err {v:.3g}" for k, v in errs.items()))
    train_inputs = TrainInputs(cfg, model, train_batch, args.seed)
    train_errs = check_train_kernels(train_inputs)
    errs.update(train_errs)
    dtemp_rel = train_errs.pop("spatial_softmax_bwd_dtemp_rel")
    print(f"[kernels] training kernels agree with their plain versions at the step's shapes: "
          + ", ".join(f"{k} max abs err {v:.3g}" for k, v in train_errs.items())
          + f"; SpatialSoftmax temperature gradient (T = 0.7) relative err {dtemp_rel:.3g}")
    debug_fwd, debug_dx, debug_dt = check_debug(args.seed)
    errs["spatial_softmax"] = max(errs["spatial_softmax"], errs.pop("spatial_softmax_train"), debug_fwd)
    errs["spatial_softmax_bwd"] = max(errs["spatial_softmax_bwd"], debug_dx)
    errs["spatial_softmax_bwd_dtemp_rel"] = max(dtemp_rel, debug_dt)
    nll_fwd_err, nll_bwd_err = check_mixture_shapes(args.seed)
    errs["mixture_nll_fwd"] = max(errs["mixture_nll_fwd"], nll_fwd_err)
    errs["mixture_nll_bwd"] = max(errs["mixture_nll_bwd"], nll_bwd_err)
    plan_fwd_err, plan_bwd_err = check_plan_shapes(args.seed)
    errs["plan_st_kl_fwd"] = max(errs["plan_st_kl_fwd"], plan_fwd_err)
    errs["plan_st_kl_bwd"] = max(errs["plan_st_kl_bwd"], plan_bwd_err)
    if (DECODER_ROWS, DECODER_SEQ) != (2 * BATCH_PER_MOD, SEQ):
        fail(f"the recurrence's step shape {(DECODER_ROWS, DECODER_SEQ)} is not the train step's")
    errs["rnn_relu_fwd"], errs["rnn_relu_bwd"] = check_recurrence(model, args.seed)

    print(f"[time] phase 4-5 at {time.perf_counter() - t_start:.1f} s")
    # ---- 4-5. serving main path ------------------------------------------------
    lang = rng.normal(size=384).astype(np.float32)
    single_obs = make_obs(rng, cfg, args.steps)
    langs = rng.normal(size=(args.lanes, 384)).astype(np.float32)
    batched_obs = [make_obs(rng, cfg, args.lanes) for _ in range(args.steps)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    single_actions, single_states = drive_single(cfg, model, single_obs, lang, args.seed)
    batched_actions, batched_states = drive_batched(cfg, model, batched_obs, langs, args.seed)
    torch.cuda.synchronize()
    serve_launches = {k.symbol: k.launches for k in kernels.ALL_KERNELS}
    print(f"[serving main path] launches: {serve_launches}")
    if not all(serve_launches[k] > 0 for k in SERVING_KERNELS):
        fail(f"a kernel of the serving path was never launched: {serve_launches}")
    check_actions("single lane", single_actions, 1)
    check_actions("batched", batched_actions, args.lanes)

    print(f"[time] phase 6 at {time.perf_counter() - t_start:.1f} s")
    # ---- 6. serving plain path -------------------------------------------------
    p_actions, p_plans = plain_single(cfg, plain_model, single_obs, lang, args.seed, single_states)
    k_plans = np.stack([s.plan[0].cpu().numpy() for s in single_states[1:]])
    replanned = np.array([t % cfg.replan_freq == 0 for t in range(args.steps)])
    compare_plain("single lane", single_actions, p_actions, k_plans, p_plans, replanned, cfg)
    masks = [replan_mask(t, args.lanes, cfg.replan_freq) for t in range(args.steps)]
    p_actions, p_plans = plain_batched(
        cfg, plain_model, list(zip(batched_obs, [langs] * args.steps, batched_states, masks)), args.seed
    )
    k_plans = np.stack([s[0].cpu().numpy() for s in batched_states[1:]])
    replanned = np.stack(masks)
    compare_plain("batched", batched_actions, p_actions, k_plans, p_plans, replanned, cfg)

    print(f"[time] phase 7 at {time.perf_counter() - t_start:.1f} s")
    # ---- 7. serving timing -------------------------------------------------------
    single_ms, batched_ms = time_policy(cfg, model, rng, args.lanes)
    print(f"[timing] policy step (entry point, host clock, median): 1 lane {single_ms:.4f} ms, "
          f"{args.lanes} lanes {batched_ms:.4f} ms ({card})")
    timing = time_kernels(model, cfg, args.lanes, rng)
    timing.update({f"{k}_1_lane": t for k, t in time_kernels(model, cfg, 1, rng).items()})
    for t in timing.values():
        t["library_ms"] = None  # no one PyTorch call computes these functions
    del plain_model

    print(f"[time] phase 8 at {time.perf_counter() - t_start:.1f} s")
    # ---- 8. training main path ---------------------------------------------------
    trainer = Trainer(cfg, TrainerConfig(seed=args.seed), "cuda")
    trainer.init_state(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    step_losses, host, events = drive_training(trainer, train_batch, cfg.loss.kl_beta, args.train_steps)
    train_launches = {k.symbol: k.launches for k in kernels.ALL_KERNELS}
    table_builds = sum(t.builds for t in trainer.optimizer.tables.values())
    print(f"[training main path] launches: {train_launches}; the Adam pointer table built {table_builds} "
          f"times in {args.train_steps} steps")
    if not all(train_launches[k] > 0 for k in TRAIN_KERNELS):
        fail(f"a kernel of the training path was never launched: {train_launches}")
    for i, losses in enumerate(step_losses):
        if not all(np.isfinite(v) for v in losses.values()):
            fail(f"training step {i}: a loss is not finite: {losses}")
    print("[training main path] " + "; ".join(
        f"step {i}: total {l['total_loss']:.5f} action {l['action_loss']:.5f} kl {l['kl_loss']:.6f} "
        f"clip {l['lang_clip_loss']:.5f} grad_norm {l['grad_norm']:.5f}" for i, l in enumerate(step_losses)))
    step_ms, event_ms = statistics.median(host[2:]), statistics.median(events[2:])
    batch_windows = 2 * BATCH_PER_MOD
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[timing] train step (2B={batch_windows}, S={SEQ}, median of {len(host) - 2} after 2 warm-ups): "
          f"host clock {step_ms:.4f} ms, CUDA events {event_ms:.4f} ms, {batch_windows / step_ms * 1e3:.2f} seq/s; "
          f"all steps host {[round(t, 4) for t in host]} ms; peak memory {peak_gb:.2f} GB ({card})")
    del trainer

    print(f"[time] phase 9 at {time.perf_counter() - t_start:.1f} s")
    # ---- 9. training plain path --------------------------------------------------
    train_check = compare_train_plain(cfg, model, train_batch, args.seed)

    # the same check with a learnable SpatialSoftmax temperature (at 0.7):
    # the backward kernel then also gives the temperature's gradient
    learn_cfg = with_learnable_temperature(cfg)
    learn_model = make_model(learn_cfg, "cuda", seed=args.seed)
    with torch.no_grad():
        learn_model.perceptual_encoder.rgb_static_encoder.spatial_softmax.temperature.fill_(0.7)
    kernels.reset_launch_counts()
    train_check["learnable_t"] = compare_train_plain(
        learn_cfg, learn_model, train_batch, args.seed, label="train plain path, learnable T = 0.7"
    )
    if not kernels.SPATIAL_SOFTMAX_BWD.launches > 0:
        fail("the train step with a learnable temperature never launched the backward kernel")
    del learn_model

    print(f"[time] phase 10 at {time.perf_counter() - t_start:.1f} s")
    # ---- 10. training timing -----------------------------------------------------
    timing.update(time_train_kernels(train_inputs))
    timing.update(time_recurrence(model, args.seed))
    launch_floor_ms = timing.pop("launch_floor")["ms"]
    print(f"[timing] empty launch (csrc/launch_floor.cu): device time {launch_floor_ms:.6f} ms, the floor "
          f"under every kernel's device time ({card})")
    for name, t in timing.items():
        lib = "" if t["library_ms"] is None else f", library call {t['library_ms']:.5f} ms"
        t["bound_share"] = t["bound_ms"] / t["ms"]
        shape = f" at {tuple(t['shape'])}" if "shape" in t else ""
        print(f"[timing] {name}{shape}: device time kernel {t['ms']:.6f} ms, plain {t['plain_ms']:.6f} ms "
              f"(kernel / plain {t['ms'] / t['plain_ms']:.4f}), bound {t['bound_ms']:.6f} ms ({t['bound_by']}), "
              f"{100 * t['bound_share']:.1f}% of the bound{lib}; per call with the host's launch "
              f"cost kernel {t['call_ms']:.5f} ms, plain {t['plain_call_ms']:.5f} ms ({card})")
        if "event_ms" in t:
            print(f"[timing] {name}: CUDA events {t['event_ms']:.6f} ms a launch, "
                  f"{t['event_ms'] / launch_floor_ms:.2f}x the empty launch's device time ({card})")
    hidden = cfg.action_decoder.hidden_size
    rec_plans = {d: recurrence_plan_for(DECODER_ROWS, DECODER_SEQ, hidden, d) for d in (False, True)}
    for fn in ("preprocess_rgb_kernel<float>", "preprocess_rgb_shift_kernel<float>", "spatial_softmax_kernel<float>",
               "spatial_softmax_bwd_kernel<float>", "preprocess_rgb_kernel<__nv_bfloat16>",
               "preprocess_rgb_shift_kernel<__nv_bfloat16>", "spatial_softmax_kernel<__nv_bfloat16>",
               "spatial_softmax_bwd_kernel<__nv_bfloat16>", "spatial_softmax_temperature_grad_kernel",
               "mixture_nll_fwd_kernel",
               "mixture_nll_bwd_kernel", "adam_lowp_kernel<__nv_bfloat16, 0>", "adam_lowp_kernel<float, 0>",
               "adam_lowp_kernel<float, 1>", "adam_lowp_kernel<float, 2>", "grad_norm_finish_kernel",
               "rnn_fwd_kernel<false, false>",
               "rnn_bwd_kernel<false, false>", "rnn_step_kernel<false>", "rnn_fwd_kernel<true, true>",
               "rnn_bwd_kernel<true, true>", "rnn_step_kernel<true>", "rnn_fwd_kernel<false, true>",
               "rnn_bwd_kernel<false, true>", "gated_fwd_kernel<false, true>", "gated_bwd_kernel<false, true>",
               "logistic_mixture_sample_kernel",
               "plan_st_kl_fwd_kernel<true>", "plan_st_kl_fwd_kernel<false>", "plan_st_kl_bwd_kernel<true>",
               "plan_st_kl_bwd_kernel<false>", "resize_preprocess_kernel<unsigned char, 0, false>",
               "resize_preprocess_kernel<unsigned char, 1, false>", "resize_preprocess_kernel<unsigned char, 0, true>",
               "resize_preprocess_kernel<float, 2, false>", "depth_noise_draw_kernel<0, false>",
               "depth_noise_draw_kernel<1, false>"):
        r = resources[fn]
        print(f"[timing] {fn}: {r['registers']} registers, {r['static_smem_bytes']} B static shared memory "
              f"(+ dynamic, set at launch), spills {r['spill_store_bytes']} / {r['spill_load_bytes']} B")
    for backward, plan in rec_plans.items():
        print(f"[timing] rnn_relu {'backward' if backward else 'forward'} at {(DECODER_ROWS, DECODER_SEQ, hidden)}: "
              f"{-(-hidden // plan.cols)} clusters of {plan.cluster} blocks, {plan.cols} columns a cluster, "
              f"k-slice {plan.k_slice}, {plan.smem_bytes} B dynamic shared memory per block, one block per SM, "
              f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    print(f"[time] phase 11 at {time.perf_counter() - t_start:.1f} s")
    # ---- 11. the LH-MTLC evaluator -------------------------------------------
    evaluator, eval_batched, eval_seq = run_evaluator(cfg, model, args.seed, card)
    eval_launches = {k: eval_batched[k] + eval_seq[k] for k in eval_batched}

    print(f"[time] phase 12 at {time.perf_counter() - t_start:.1f} s")
    # ---- 12. the training loop -----------------------------------------------
    del model, train_inputs, train_batch
    torch.cuda.empty_cache()
    training_loop, loop_launches, window = run_training_loop(cfg, args.seed, card, batch_windows / step_ms * 1e3)
    errs["preprocess_rgb"] = max(errs["preprocess_rgb"], *(t["max_abs_err"] for t in window.values()))
    timing["preprocess_rgb_window"], timing["preprocess_rgb_gripper_window"] = window["rgb_static"], window["rgb_gripper"]

    print(f"[time] phase 13 at {time.perf_counter() - t_start:.1f} s")
    # ---- 13. the serving export ----------------------------------------------
    model = make_model(cfg, "cuda", seed=args.seed)
    serving_export, served_launches = run_serving_export(
        {"hulc": (cfg, model, SERVING_KERNELS)}, args.seed, args.lanes, single_obs, lang, batched_obs, langs, card
    )
    del model
    torch.cuda.empty_cache()

    print(f"[time] phase 14 at {time.perf_counter() - t_start:.1f} s")
    # ---- 14. mcil at full width ----------------------------------------------
    mcil, mcil_launches, mcil_errs, mcil_timing = run_mcil(args.seed, args.lanes, args.train_steps, card)
    errs.update({k: max(errs.get(k, 0.0), v) for k, v in mcil_errs.items()})
    timing.update(mcil_timing)

    print(f"[time] phase 15 at {time.perf_counter() - t_start:.1f} s")
    # ---- 15. hulc_depth at full width ----------------------------------------
    depth, depth_launches, depth_errs, depth_timing = run_depth(args.seed, args.train_steps, card)
    errs.update({k: max(errs.get(k, 0.0), v) for k, v in depth_errs.items()})
    timing.update(depth_timing)

    print(f"[time] phase 16 at {time.perf_counter() - t_start:.1f} s")
    # ---- 16. the decoder's gru and lstm cells at full width ------------------
    gated, gated_launches, gated_errs, gated_timing = run_gated(args.seed, args.lanes, step_ms, card)
    errs.update(gated_errs)
    timing.update(gated_timing)

    print(f"[time] phase 17 at {time.perf_counter() - t_start:.1f} s")
    # ---- 17. hulc in bf16 at full width --------------------------------------
    bf16, bf16_launches, bf16_errs, bf16_timing = run_bf16(args.seed, args.lanes, args.train_steps, step_ms, peak_gb,
                                                           card)
    errs.update(bf16_errs)
    timing.update(bf16_timing)
    timing["preprocess_rgb_bf16"] = timing.pop("preprocess_rgb_bf16_window")

    print(f"[time] phase 18 at {time.perf_counter() - t_start:.1f} s")
    # ---- 18. B.5' and the train and evaluate CLIs at full width ---------------
    clis, clis_launches, clis_errs, clis_timing = run_phase18(args.seed, card)
    errs.update(clis_errs)
    timing.update(clis_timing)
    # B.5's row by events too: the profiler's window (phase 10) drops some of its launches and reads short
    b5 = clis["adam_lowp_events"]
    timing["adam_lowp"].update(profiler_ms=timing["adam_lowp"]["ms"], ms=b5["ms"], event_plain_ms=b5["plain_ms"],
                               event_library_ms=b5["library_ms"])

    print(f"[time] phase 19 at {time.perf_counter() - t_start:.1f} s")
    # ---- 19. the BiRNN's relu and gru cells (B.13), dropout, the encoders' options
    b13, b13_launches, b13_errs, b13_timing = run_phase19(args.seed, args.lanes, card)
    errs.update(b13_errs)
    timing.update(b13_timing)

    print(f"[time] phase 20 at {time.perf_counter() - t_start:.1f} s")
    # ---- 20. data-parallel and ZeRO-3 training ---------------------------------
    parallel, parallel_launches = run_parallel(args.seed, card)

    print(f"[time] phase 21 at {time.perf_counter() - t_start:.1f} s")
    # ---- 21. GCBC, the deterministic decoder, state-only, the auxiliary losses
    variants, variants_launches, variants_errs = run_phase21(args.seed, args.lanes, card)
    errs.update({k: max(errs.get(k, 0.0), v) for k, v in variants_errs.items()})

    print(f"[time] phase 22 at {time.perf_counter() - t_start:.1f} s")
    # ---- 22. the frozen CLIP and tactile encoders, the resize and B.15 -------
    encoders, encoders_launches, b15, b15_timing = run_phase22(args.seed, args.lanes, card)
    errs["resize_preprocess"] = max(r["max_abs_err"] for r in b15.values())
    timing["resize_preprocess"] = {**b15_timing["clip_train_fp32"],
                                   "max_flip_share": max(r["flip_share"] for r in b15.values())}
    timing.update({f"b15_{k}": v for k, v in b15_timing.items() if k != "clip_train_fp32"})

    rows = []
    for name, (symbol, source, replaces) in KERNEL_INFO.items():
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": serve_launches[symbol] + train_launches[symbol] + eval_launches[symbol]
            + loop_launches[symbol] + served_launches[symbol] + mcil_launches[symbol] + depth_launches[symbol]
            + gated_launches[symbol] + bf16_launches[symbol] + clis_launches[symbol] + b13_launches[symbol]
            + parallel_launches[symbol] + variants_launches[symbol] + encoders_launches[symbol],
            "launches_serving": serve_launches[symbol], "launches_training": train_launches[symbol],
            "launches_evaluator": eval_launches[symbol], "launches_training_loop": loop_launches[symbol],
            "launches_served": served_launches[symbol], "launches_mcil": mcil_launches[symbol],
            "launches_depth": depth_launches[symbol], "launches_gated": gated_launches[symbol],
            "launches_bf16": bf16_launches[symbol], "launches_clis": clis_launches[symbol],
            "launches_b13": b13_launches[symbol], "launches_parallel": parallel_launches[symbol],
            "launches_variants": variants_launches[symbol], "launches_encoders": encoders_launches[symbol],
            "max_abs_err": errs[name], **timing[name], "launch_floor_ms": launch_floor_ms,
        })
        rows[-1].update({extra: timing[key] for extra, key in EXTRA_TIMINGS.get(name, {}).items()})
        if name == "spatial_softmax_bwd":
            rows[-1]["learnable_t"]["dtemp_rel_err"] = errs["spatial_softmax_bwd_dtemp_rel"]
        if name == "spatial_softmax_bwd_bf16":
            rows[-1]["learnable_t"]["dtemp_rel_err"] = errs["spatial_softmax_bwd_bf16_dtemp_rel"]
    print(json.dumps({
        "policy_step_ms": {"1": single_ms, str(args.lanes): batched_ms},
        "train_step": {"batch": batch_windows, "seq": SEQ, "host_ms": step_ms, "event_ms": event_ms,
                       "seq_per_s": batch_windows / step_ms * 1e3, "steps_host_ms": host,
                       "peak_memory_gb": peak_gb, "adam_table_builds": table_builds, "plain_path": train_check},
        "evaluator": evaluator, "training_loop": training_loop, "serving_export": serving_export, "mcil": mcil,
        "hulc_depth": depth, "gated_decoder": gated, "bf16": bf16, "clis": clis, "b13": b13, "parallel": parallel,
        "variants": variants, "encoders": encoders,
        "launch_floor_ms": launch_floor_ms, "card": card,
    }))
    print(f"[time] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
