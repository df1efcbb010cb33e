#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sheeprl_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. card: name and power limit (``nvidia-smi``) and ``torch.cuda.get_device_name``;
2. build: every CUDA source of the port, one ``nvcc`` each, started together;
3. kernels: each kernel against its plain PyTorch version on the card, with
   TF32 off; error, tolerance, and device time per call (20 calls captured
   in one CUDA graph, CUDA events around each of 50 replays queued behind a
   busy stream, median) beside the plain version's and the bound, and the
   product variant each shape launches:
   - the cell at the serving and acting shapes, B=1, 4, 16, 64 (also eager
     time per call: events around each of 200 calls, host launch gaps
     included);
   - the cell at the training shapes (B=32, 801, 1600), with the hand VJP's
     six gradients against autograd of the plain version;
   - at B=32, 64 and 1600 the cell's time split into its product kernel and
     its gate kernel (the profiler's kernel records, ``tools/bench_cell.py``)
     beside cuBLAS's f32 SGEMM of the same product ``[h|x]·W``
     (``torch.matmul``, TF32 off): the yardstick, never called by the port;
   - the sequence at SEQUENCE_SHAPES (the kernel bench's, an odd one, B=64,
     and one past the persistent recurrence's limits): the variant the plan
     picks, forward and gradients against the plain loop; then each variant
     that fits launched by name, with its device launches per call and its
     time split into input projection and recurrence (profiler kernel
     records), and the persistent recurrence's synchronisation alone a step;
4. slice: a DreamerV2 agent at the full MsPacman width (rgb 3x64x64,
   channels 48/96/192/384, dense 400, recurrent 600, 32x32 latent, 9
   actions), seeded random weights, behind the port's ``ServeGateway`` with
   ``max_batch=64``; 64 clients x 16 lockstep requests of seeded uint8
   frames, then the same requests again through a gateway whose recurrent
   cell runs the plain version, which must give the same actions;
5. bench_kernels: the port's ``tools/bench_kernels.py`` (forward and
   backward of the sequence, kernel against the plain loop);
6. train: the DreamerV2 trainer at the full MsPacman width (B=32, T=50,
   horizon 15): one step at fixed weights and noise on the kernel path and
   on the plain-cell path, TF32 off, whose losses and gradient norms must
   agree; GRAPH_STEPS steps from one seed eager and graphed (the capture's
   eager warm-up calls, the capture, then replays of the whole gradient
   step from one CUDA graph), whose losses, gradient norms and parameters
   must agree within TOL_GRAPHED with ``cudnn.deterministic`` (with cuDNN's
   default algorithms, whose convolution weight gradients accumulate with
   atomics, two eager runs differ too, and graphed against eager must stay
   within GRAPHED_DEFAULT_SPREADS times their spread); then, on fresh
   trainers of the same seed, one warm-up step and TRAIN_STEPS timed steps
   eager and as many graphed,
   with every loss finite and exactly 65 cell launches a step in both (50
   posterior steps at B=32, 15 imagination steps at B=1600), each with a
   profiled window of as many steps;
7. run: the port's main path, ``sheeprl_tpu_torch.cli.run`` with RUN_ARGS
   (``exp=dreamer_v2_ms_pacman`` at its full width on the dummy env with
   the preset's episode buffer, ``prioritize_ends`` and ``log_level=1``: 4
   envs, 1088 policy steps, learning from step 544, a buffer of 4096 steps,
   a log every 256 policy steps): 272 updates, 136 acting steps of the
   player and 35 gradient steps, each replayed from its CUDA graph after
   three eager warm-up calls, a checkpoint at the last update and a
   129-step greedy test episode. The cell must launch exactly once per
   acting step, 65 times per gradient step and once per test step, the
   sequence never; the event file, read back with the port's reader, must
   hold the preset's tags at the log boundaries with finite values; the
   checkpoint must validate (manifest and every crc32) and its episode
   buffer restore into a fresh buffer with an equal ``state_dict``; then
   ``load_gateway_model`` serves that checkpoint to 16 clients x 8 lockstep
   requests, whose actions must equal a plain-cell replay's. The run is
   traced (CUDA activity only, so its rates are read under the profiler):
   the trace gives the device's busy time, and the cell's gate kernels in
   it must equal the run's counters. The run's rates print beside
   PR5_RATES.

DreamerV3 (PR 7), at the 100k MsPacman preset's full width (rgb 3x64x64,
encoder channels 32/64/128/256, dense 512 x 2, recurrent 512, 32x32
latent, 255-bin two-hot reward and critic, B=16 x T=64, horizon 15, f32):

- dv3 kernels (after phase 3's training shapes): the cell at H = X = 512,
  no bias, eps 1e-3, at B=1, 10, 16, 64 and 1024 (acting and test, the eval
  pool, posterior, a serving batch, imagination), forward and the five gradients against the plain version,
  device time, bound and cuBLAS's product (``phase_cell_dv3``);
- train_dv3 (after phase 6): one step kernel against plain cell (TF32
  off), GRAPH_STEPS steps graphed against eager with
  ``cudnn.deterministic``, then DV3_TRAIN_STEPS timed steps eager and
  graphed with a profiled window, 79 cell launches a step (64 posterior
  steps at B=16, 15 imagination steps at B=1024);
- run_dv3 (after phase 7): ``cli.run`` with RUN_DV3_ARGS
  (``exp=dreamer_v3_100k_ms_pacman`` on ``discrete_dummy``: 1088 policy
  steps, learning from the preset's 1024, 64 acting steps, 65 gradient
  steps, a 5-step test episode that samples its actions), the same checks
  as phase 7 with the sequential buffer restored equal from the
  checkpoint, and 64 + 79 x 65 + 5 cell launches.

Continuous actions: DreamerV3's DMC walker_walk preset at full width
(rgb 3x64x64 plus the 24-wide ``state`` vector, channels 32/64/128/256, an
MLP encoder and decoder on ``state``, dense 512 x 2, recurrent 512, 32x32
latent, 6 actions through a ``trunc_normal`` actor that learns by dynamics
backprop, so its gradient runs back through the 15 imagination cell steps):

- the dv3 kernel rows gain the cell's VJP at B=1024 as the walker's
  imagination runs it (dh and dx, the kernel frozen) and with the weight
  gradient, beside the forward and their bounds (``dv3_walker_vjp``), and
  at the posterior's B=16 (``dv3_posterior_vjp``);
- train_walker (after train_dv3): one step kernel against plain cell (TF32
  off), GRAPH_STEPS steps graphed against eager bit for bit with
  ``cudnn.deterministic``, the actor loss's forward and backward device
  times apart, then DV3_TRAIN_STEPS timed steps eager and graphed with a
  profiled window and the peak memory, 79 cell launches a step;
- train_dv2_continuous: GRAPH_STEPS DreamerV2 steps at ``exp=dreamer_v2``'s
  width on a 2-wide Box of actions, graphed against eager;
- run_walker (after run_dv3): ``cli.run`` with RUN_WALKER_ARGS on
  ``walker_stand_in`` (dm_control's walker spaces; the card has no
  dm_control), the same checks as run_dv3 with the float actions served
  (kernel against plain cell within TOL_CONTINUOUS_ACTION) and the greedy
  best-of-100 actions of the checkpoint's weights against a plain-cell
  replay at the same injected noise; 64 + 79 x 33 + 1000 cell launches.

Evaluation, registration and serving, eval_serve (after run_walker,
on run_dv3's and run_walker's checkpoints; the dv3 kernel rows gain B=10,
the eval pool's batch, and B=64, a full serving batch):

- ``cli.evaluation`` of each checkpoint at ``eval.episodes=10``: eval.json
  with the JAX package's keys, one registry line, one cell launch a pool
  step, and every pool step's actions against a plain-cell evaluation at
  the same seeds (equal; the walker's within TOL_CONTINUOUS_ACTION);
- ``cli.registration`` of the DV3 checkpoint, the cold start of
  ``ServeGateway.from_checkpoint("registry:best:dreamer_v3:<env>")``, and
  ``rescore_through_gateway`` of that ref: returns, lengths and every step's
  actions bit for bit the evaluation's, one cell launch a batch;
- the ``serve`` command in a subprocess, its ring driven by SERVE_CLIENTS
  spawned clients (``serve/loadgen.py``); once all have had an answer, a
  publication of perturbed weights into the watched ``poll_root`` mid-load,
  the clients stopped, then SIGTERM: no failed request, versions monotone for every client, at
  least one swap, ``drained=clean`` and exit 0, one cell launch a batch;
  requests/s, latency p50/p99, publication-to-new-version and drain time;
- in-run evaluation on a DV3 run at the 100k width (INRUN_ARGS): the
  sidecar's curve, the spawned CPU child never initialising CUDA, and the
  trainer's launches still the player steps + 79 a gradient step + the test
  steps.

Plan2Explore, at its presets' full widths (P2E-DV3: DreamerV3's
default algo width, dense 256 x 1, CNN multiplier 24, recurrent 256 without
bias, 32x32 latent, an 8-member ensemble, an intrinsic and an extrinsic
exploration critic, B=16 x T=64; P2E-DV2: dense 400 x 4, recurrent 400 with
bias, a 10-member ensemble, B=16 x T=50; both horizon 15):

- p2e kernels (after the dv3 rows): the cell at P2E_CELL_SHAPES (H = X =
  256 without bias; H = X = 400 with bias, eps 1e-5) at B = 4, 10, 16, 64
  and the imagination's 1024 or 800, forward and gradients against the plain
  version, device time, bound, cuBLAS's product, the VJP at the posterior's
  and the imagination's batches (``phase_cell_p2e``);
- train_p2e_dv3, train_p2e_dv3_continuous, train_p2e_dv2 (after
  train_dv2_continuous): one exploration step (six updates) kernel against
  plain cell (TF32 off), GRAPH_STEPS steps graphed against eager within
  TOL_GRAPHED with ``cudnn.deterministic``, then P2E_TRAIN_STEPS timed steps
  eager and graphed with a profiled window, P2E_STEP_LAUNCHES (94, 94, 80)
  cell launches a step (two imaginations a step);
- run_p2e_dv3, run_p2e_dv2 (after eval_serve): ``cli.run`` of the
  exploration preset, then of the finetuning preset from its checkpoint
  (RUN_P2E_SPECS, cuts listed there), whose player switches from the
  exploration actor to the task actor inside the run; each run's counters,
  cell launches (as predicted), graphs (one captured acting step per actor),
  event tags and deep-validated checkpoint; the exploration run traced, its
  gate kernels equal to its counters; the evaluation command on the finetuning
  checkpoint against a plain-cell evaluation; and its task actor served to
  lockstep clients, equal to a plain-cell replay (``phase_run_p2e``).

DreamerV3 at the L and XL widths in f32 and under bf16-mixed: the
L DIAMBRA preset (``exp=dreamer_v3_L_doapp``: recurrent 2048, dense 768 x 4,
CNN multiplier 64, 8 envs), the XL Crafter preset
(``exp=dreamer_v3_XL_crafter``: recurrent 4096, dense 1024 x 5, CNN
multiplier 96) and P2E-DV3's L DIAMBRA presets at their ``bf16-mixed``
(recurrent 1024, dense 768 x 4, CNN multiplier 48, grey frames, 16 envs), on
``doapp_stand_in`` and ``crafter_stand_in`` (the DIAMBRA and Crafter wrappers'
spaces; the card has neither simulator):

- cell_l_xl and cell_bf16 kernels (after the P2E rows): the cell at
  LARGE_CELL_SHAPES in f32 (forward and gradients against the plain
  version, the VJP, cuBLAS's product, the bound; ``phase_cell_large``), and
  its bf16 operand path at BF16_CELL_SHAPES against the plain bf16 cell
  (``hafner_bound_bf16``: one bf16 pass at 989 TFLOP/s, or the bytes the
  kernel reads; cuBLAS's GEMM on bf16 operands; ``phase_cell_bf16``);
- train_p2e_dv3_L_bf16, train_dv3_L, train_dv3_XL (after the P2E
  trainers): as train_p2e_dv3 and train_dv3, the bf16 trainer's kernel
  against plain cell within TOL_TRAIN_BF16, the large ones' metrics and
  policy loss within TOL_TRAIN_GRAD scaled by K = H + X (the readings behind
  that limit: ``python3 chip_smoke.py --train-gaps``), every launch on the
  expected operand path;
- run_p2e_dv3_L_bf16 (after the P2E runs) and run_dv3_L, run_dv3_XL (last):
  the presets through the CLI at full width, 9 gradient steps each, the
  same checks as the runs before them, and every floating array of each
  checkpoint's agent f32 (``_f32_parameters``).

DreamerV1 and Plan2Explore on it, at their presets' full widths (DV1:
recurrent 200, a Gaussian stochastic state of 30, dense 400 x 4, CNN
multiplier 32, B=50 x T=50, horizon 15; P2E-DV1: recurrent 400, stochastic
60, 10 members regressing the 1,024-wide observation embedding). Their
recurrent core is flax's GRU cell, PyTorch operations on the card as the JAX
package computes it outside any Pallas kernel, so every one of their paths
must launch hafner_cell 0 times:

- train_dv1, train_p2e_dv1 (after the L and XL trainers): the card's step
  against the port's own CPU step on the same weights, batch and noise at
  B=8 x T=16 (DV1_CPU_OVERRIDES: TF32 off, the updates that feed later
  losses at lr 0; losses within TOL_TRAIN_LOSS, the other metrics within
  TOL_TRAIN_GRAD, relative), GRAPH_STEPS steps graphed against eager within
  TOL_GRAPHED with ``cudnn.deterministic`` (for DV1 also on a 2-wide Box of
  actions), then DV1_TRAIN_STEPS timed steps eager and graphed with a
  profiled window and the peak memory (``phase_train_dv1``);
- run_p2e_dv1 (after the other P2E runs) and run_dv1 (after them):
  ``cli.run`` of RUN_P2E_SPECS["p2e_dv1"] (exploration, then finetuning with
  the actor switch) and of RUN_DV1_ARGS, checked as the runs before them
  (counters, graphs, event tags, deep-validated f32 checkpoints, DV1's
  sequential buffer restored equal), the evaluation command on the
  finetuning checkpoint, and the served actions of both checkpoints held
  against their evaluation policy's on the same frames and noise
  (``eval_policy_lockstep``).

Each path's launch counts are zeroed just before its run and read just
after it: the served run (phase 4), the bench (phase 5), the timed train
steps (phases 6, train_dv3, train_walker) and the graphed steps
(train_dv2_continuous), the training runs (phases 7, run_dv3 and
run_walker), and eval_serve's evaluations, rescore, serve command and
in-run run (``launches_by_path``), and the P2E trainers, runs, evaluations and
serving, and the DreamerV1 paths (``dv1_paths``, each 0). The ``kernels``
line's cell ``launches`` is the f32 training runs' sum (the six Dreamer runs and the six f32 P2E runs, DV1's
at 0; the bf16 P2E runs' are ``hafner_cell_bf16``'s); its ``p2e_shapes`` and
``p2e_train`` keys carry the P2E rows. The build phase also counts the tensor-core instructions
(``HGMMA``, ``HMMA``) in the built library's SASS (``cuobjdump -sass``).

Bounds: the least time of the same work on an H100 SXM, the larger of its
bytes (each input read once, each output written once) at 3.35 TB/s and its
operations, the product ``[h|x]·W`` at f32 accuracy on the tensor cores
(three TF32 passes at 495 TFLOP/s) plus the LayerNorm and gates at the f32
rate (67 TFLOP/s). ``bound_f32_simt_ms`` keeps the earlier convention (the
whole product at 67 TFLOP/s), so that older rows stay comparable.

The last lines are the ``[timing]`` line (each phase's seconds), the card
line, one JSON line with a record per kernel (``hafner_cell``, its bf16
operand path ``hafner_cell_bf16``, ``hafner_sequence``), and ``{"ok": true,
"device": {...}}``. Exits non-zero, without that last
line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

TOL_KERNEL = 1e-4  # abs: 3xTF32 on the tensor cores against f32, another summation order over K=1000
TOL_STATE = 1e-3  # abs: recurrent state after 16 chained steps, kernel vs plain cell
TOL_SEQUENCE = 1e-4  # abs: hs over T chained steps (the JAX suite's sequence tolerance is rtol 1e-4)
TOL_GRAD = 1e-4  # relative to each gradient's largest magnitude: f32, other summation orders
# kernel path against plain-cell path, one full-width train step at fixed weights and noise (TF32
# off): relative, losses and gradient global norms. Read on the card: losses equal to the last f32
# bit, gradient norms within 1.1e-7. These norms are dominated by the decoder and heads, so a wrong
# gradient of one of the cell's small leaves would not show here: phase_cell_training checks each of
# the cell's six gradients against autograd of the plain version
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-4
TRAIN_STEPS = 4
CELL_LAUNCHES_PER_STEP = 65  # 50 posterior steps + 15 imagination steps
# (T, B, H, X, bias, LayerNorm, eps, the variant the plan must pick): the kernel bench's shape; an odd
# one (last unit group of 11 units, scalar copies, no bias, no LayerNorm); the widest batch the
# persistent recurrence takes; one past its limits (W[:H]'s hi/lo slices do not fit on chip)
SEQUENCE_SHAPES = (
    (50, 16, 600, 400, True, True, 1e-3, "persistent"),
    (7, 5, 599, 37, False, False, 1e-3, "persistent"),
    (50, 64, 600, 400, True, True, 1e-3, "persistent"),
    (8, 16, 2048, 512, True, True, 1e-3, "multi_launch"),
)
SYNC_FLOOR_STEPS = 100
# graphed against eager train steps, full width, from one seed: steps compared and the limit (relative to
# each tensor's largest magnitude, losses, gradient norms and parameters)
GRAPH_STEPS = 6
TOL_GRAPHED = 1e-6
# with cuDNN's default algorithms (the run's), where two eager runs already differ: graphed against eager
# within this multiple of the spread between two eager runs in the same call (never below TOL_GRAPHED). That
# spread is one draw of the atomics' rounding: on an H100 graphed against eager has read 0.46-5.0 times it on
# losses and parameters over four runs; with cudnn.deterministic the same steps are held to TOL_GRAPHED
GRAPHED_DEFAULT_SPREADS = 10.0
# the run phase: the port's CLI with the preset's own buffer (episodes, prioritize_ends) and logging
# (log_level 1) at the full MsPacman width on the dummy env (2 heads of 2 actions, 129-step episodes); cut:
# 4 envs, a buffer of 4096 steps, 1088 policy steps (272 updates), learning from step 544 (136 updates, so
# every env has closed an episode before the first burst), a log every 256 policy steps
RUN_ARGS = (
    "exp=dreamer_v2_ms_pacman", "env=dummy", "env.id=multidiscrete_dummy", "env.num_envs=4", "env.sync_env=True",
    "buffer.size=4096", "buffer.memmap=True", "total_steps=1088", "algo.learning_starts=544", "metric.log_every=256",
)
RUN_UPDATES, RUN_PLAYER_STEPS, RUN_GRADIENT_STEPS, RUN_TEST_STEPS = 272, 136, 35, 129
RUN_LOG_STEPS = (256, 512, 768, 1024, 1088)
# the preset's tags: at every log boundary, and at the boundaries after learning starts
RUN_TAGS_ALWAYS = ("Time/sps_env_interaction",)
RUN_TAGS_TRAINING = (
    "Loss/world_model_loss", "Loss/value_loss", "Loss/policy_loss", "Loss/observation_loss", "Loss/reward_loss",
    "Loss/state_loss", "Loss/continue_loss", "State/post_entropy", "State/prior_entropy", "State/kl",
    "Params/exploration_amount", "Grads/world_model", "Grads/actor", "Grads/critic", "Time/sps_train",
)
# PR 5's run, at its own cuts (sequential buffer, log_level 0, eager steps): policy and gradient steps/s
PR5_RATES = {"policy_steps_per_s": 76.8, "gradient_steps_per_s": 3.03}
RUN_CLIENTS, RUN_REQUESTS, RUN_ACTIONS = 16, 8, 2
# DreamerV3 (PR 7): the cell at the 100k MsPacman preset's shapes (H = X = 512, no bias, LayerNorm, eps 1e-3) at the
# batches of its paths: acting and the test episode (1 env), the eval pool (eval.episodes=10), the posterior (B=16),
# a full serving batch (64), the imagination (16 x 64)
DV3_CELL_BATCHES = (1, 10, 16, 64, 1024)
DV3_H = DV3_X = 512
DV3_EPS = 1e-3
DV3_CELL_LAUNCHES_PER_STEP = 79  # 64 posterior steps + 15 imagination steps
DV3_TRAIN_STEPS = 4
# the DV3 run: the port's CLI with exp=dreamer_v3_100k_ms_pacman at its full width (its sequential buffer checkpointed,
# log_level 1, learning from the preset's 1024, one gradient step a policy step) on the dummy env (1 head of 2
# actions, 5-step episodes); cut: a buffer of 4096 steps, 1088 policy steps (65 gradient steps: the pretrain step at
# 1024 and one a step after it), a log every 256 policy steps
RUN_DV3_ARGS = (
    "exp=dreamer_v3_100k_ms_pacman", "env=dummy", "env.id=discrete_dummy", "env.sync_env=True", "buffer.size=4096",
    "total_steps=1088", "metric.log_every=256",
)
RUN_DV3_UPDATES, RUN_DV3_PLAYER_STEPS, RUN_DV3_GRADIENT_STEPS, RUN_DV3_TEST_STEPS = 1088, 64, 65, 5
RUN_DV3_LOG_STEPS = (256, 512, 768, 1024, 1088)
# the walker: the DV3 DMC walker_walk preset at its full width (rgb and a 24-wide state, 6 continuous actions)
WALKER_OBS = {"rgb": (3, 64, 64), "state": (24,)}
WALKER_ACTIONS = 6
# the walker run: the port's CLI with exp=dreamer_v3_dmc_walker_walk at its full width (1 env, train_every 2, the memmap
# sequential buffer checkpointed, log_level 1) on walker_stand_in; cut: a buffer of 4096 steps in place of 1e5, learning
# from 1024 in place of 8000, 1088 policy steps (33 gradient steps: the pretrain step at 1024 and one every 2 after
# it), a log every 256 policy steps; the envs stepped in the process (sync) and no video capture (not ported)
RUN_WALKER_ARGS = (
    "exp=dreamer_v3_dmc_walker_walk", "env.wrapper._target_=chip_smoke.walker_stand_in", "env.sync_env=True",
    "env.capture_video=False", "buffer.size=4096", "algo.learning_starts=1024", "total_steps=1088",
    "metric.log_every=256",
)
RUN_WALKER_UPDATES, RUN_WALKER_PLAYER_STEPS, RUN_WALKER_GRADIENT_STEPS, RUN_WALKER_TEST_STEPS = 1088, 64, 33, 1000
RUN_WALKER_LOG_STEPS = (256, 512, 768, 1024, 1088)
# DIAMBRA's Dead or Alive++ as diambra.arena gives it with the env config's flattened, role-relative wrappers: the
# raw space of each key, ("box", low, high) of shape (1,) int32 or ("discrete", n), which the DIAMBRA wrapper
# (sheeprl_tpu/envs/diambra.py:93-106) keeps as a Box or turns into a 1-wide int32 Box of [0, n - 1]. The P2E L
# presets name the role-relative keys; the L preset names the legacy ones (verbatim from its reference recipe); the
# stand-in offers both. 11 characters; 16 combo-discrete actions (9 moves + 8 attack-button combinations - 1 shared
# no-op), also the last action's key
DOAPP_ACTIONS = 16
DOAPP_RAW_KEYS = {
    **{f"{side}_{k}": v for side in ("own", "opp") for k, v in (
        ("character", ("discrete", 11)), ("health", ("box", 0, 208)), ("side", ("discrete", 2)),
        ("wins", ("box", 0, 2)))},
    "stage": ("box", 1, 8), "timer": ("box", 0, 40), "action": ("discrete", DOAPP_ACTIONS),
    **{f"P1_{side}{k}": v for side in ("own", "opp") for k, v in (
        ("Char", ("discrete", 11)), ("Health", ("box", 0, 208)), ("Side", ("discrete", 2)), ("Wins", ("box", 0, 2)))},
    "P1_actions_move": ("discrete", 9), "P1_actions_attack": ("discrete", 8),
}
CRAFTER_ACTIONS = 17
# a stand-in's episodes end after this many steps (a round, a Crafter life): the runs' test episodes stay short
STAND_IN_EPISODE = 32
# the L and XL runs: the port's CLI with exp=dreamer_v3_L_doapp (8 envs, train_every 8) and exp=dreamer_v3_XL_crafter
# (1 env, train_every 2) at full width in f32 on doapp_stand_in and crafter_stand_in (DIAMBRA's and Crafter's spaces;
# the card has neither), the sequential buffer checkpointed, log_level 1. Cuts: a buffer of 4096 steps (5e6 and 1e6),
# learning from 1024 and 128 policy steps (65536 and 1024: 128 steps an env, two sequences of 64), 1088 and 144 policy
# steps (5e6 and 1e6): 9 gradient steps each (the pretrain step and 8), a log every 256 and 64 policy steps
RUN_L_ARGS = (
    "exp=dreamer_v3_L_doapp", "env.wrapper._target_=chip_smoke.doapp_stand_in", "env.sync_env=True",
    "env.capture_video=False", "buffer.size=4096", "algo.learning_starts=1024", "total_steps=1088",
    "metric.log_every=256",
)
RUN_XL_ARGS = (
    "exp=dreamer_v3_XL_crafter", "env.wrapper._target_=chip_smoke.crafter_stand_in", "env.sync_env=True",
    "env.capture_video=False", "buffer.size=4096", "algo.learning_starts=128", "total_steps=144",
    "metric.log_every=64",
)
DOAPP_L_OBS = {"frame": (3, 64, 64), **{k: (1,) for k in (
    "P1_actions_attack", "P1_actions_move", "P1_oppChar", "P1_oppHealth", "P1_oppSide", "P1_oppWins", "P1_ownChar",
    "P1_ownHealth", "P1_ownSide", "P1_ownWins", "stage")}}
DOAPP_P2E_OBS = {"frame": (1, 64, 64), **{k: (1,) for k in (
    "own_character", "own_health", "own_side", "own_wins", "opp_character", "opp_health", "opp_side", "opp_wins",
    "stage", "timer", "action", "reward")}}
CRAFTER_OBS = {"rgb": (3, 64, 64), "reward": (1,)}
# served float actions, kernel against plain cell: the cell's outputs differ by ~1e-5, the actions by as much
TOL_CONTINUOUS_ACTION = 1e-3
WALKER_GREEDY_STEPS = 4
# Plan2Explore: the cell at its presets' shapes, (H, X, bias, eps, the batches of its paths: 4 acting envs, the
# eval pool's 10, the posterior's 16, a serving batch of 64, the imagination's B x T): P2E-DV3 at DreamerV3's default
# algo width (recurrent 256 without bias, eps 1e-3; 16 x 64) and P2E-DV2 at its own (recurrent 400 with bias, DV2's
# eps 1e-5; 16 x 50)
P2E_CELL_SHAPES = {
    "p2e_dv3": (256, 256, False, 1e-3, (4, 10, 16, 64, 1024)),
    "p2e_dv2": (400, 400, True, 1e-5, (4, 10, 16, 64, 800)),
}
# cell launches a gradient step, read from the code: the posterior's T steps, then the imagination's horizon (15) once
# (DreamerV2, DreamerV3, finetuning) or twice (the P2E exploration step: the exploration and the task actor)
P2E_STEP_LAUNCHES = {"p2e_dv3": 64 + 15 + 15, "p2e_dv3_continuous": 64 + 15 + 15, "p2e_dv2": 50 + 15 + 15,
                     "p2e_dv3_L_bf16": 64 + 15 + 15}
P2E_FINETUNING_STEP_LAUNCHES = {"p2e_dv3": 64 + 15, "p2e_dv2": 50 + 15, "p2e_dv3_L_bf16": 64 + 15}
P2E_TRAIN_STEPS = 4
# the P2E runs: the port's CLI at each preset's full width on the discrete dummy env (2 actions, 5-step episodes), 4
# envs, the sequential buffer, log_level 1; exploration, then finetuning from its checkpoint, the finetuning player
# acting with the exploration actor until learning_starts and with the task actor after it, inside the run. Cuts:
# a buffer of 4096 steps (1e6 and 5e6), 1024 and 512 policy steps (P2E-DV3; 5e6 and 1e6) and 512 and 256 (P2E-DV2),
# learning from 512 and 320 (P2E-DV3; 65536 both) and 256 and 224 (P2E-DV2; 1000 both), a log every 256 (5000);
# P2E-DV2's pretraining burst at learning_starts 10 gradient steps (100)
P2E_ENV_ARGS = ("env=dummy", "env.id=discrete_dummy", "env.sync_env=True", "buffer.size=4096", "metric.log_every=256")
P2E_L_ENV_ARGS = ("env.wrapper._target_=chip_smoke.doapp_stand_in", "env.sync_env=True", "env.capture_video=False",
                  "buffer.size=4096", "metric.log_every=256")
RUN_P2E_SPECS = {
    "p2e_dv3": dict(
        exploration=("exp=p2e_dv3_exploration", "total_steps=1024", "algo.learning_starts=512") + P2E_ENV_ARGS,
        finetuning=("exp=p2e_dv3_finetuning", "total_steps=512", "algo.learning_starts=320") + P2E_ENV_ARGS,
        # (updates, random, player steps by actor, gradient steps, test steps, the update of the switch)
        exploration_counts=(256, 128, [128], 33, 5, None),
        finetuning_counts=(128, 0, [79, 49], 13, 5, 80),
    ),
    "p2e_dv2": dict(
        exploration=("exp=p2e_dv2_exploration", "total_steps=512", "algo.learning_starts=256",
                     "algo.per_rank_pretrain_steps=10") + P2E_ENV_ARGS,
        finetuning=("exp=p2e_dv2_finetuning", "total_steps=256", "algo.learning_starts=224",
                    "algo.per_rank_pretrain_steps=10") + P2E_ENV_ARGS,
        exploration_counts=(128, 64, [64], 74, 5, None),
        finetuning_counts=(64, 0, [55, 9], 18, 5, 56),
    ),
    # P2E-DV3's L DIAMBRA presets under their bf16-mixed on doapp_stand_in (grey frames, the reward as an observation,
    # 16 envs, train_every 1, B=4 and 16 x T=64). Cuts: a buffer of 4096 steps (1e6), 1152 policy steps each (2e7 and
    # 5e6), learning from 1024 (131072 and 65536: 64 steps an env, one sequence), a log every 256 (10000): 9 gradient
    # steps each, the finetuning player switching actors at update 64
    "p2e_dv3_L_bf16": dict(
        exploration=("exp=p2e_dv3_expl_L_doapp_128px_gray_combo_discrete_15Mexpl_20Mstps", "total_steps=1152",
                     "algo.learning_starts=1024") + P2E_L_ENV_ARGS,
        finetuning=("exp=p2e_dv3_fntn_L_doapp_64px_gray_combo_discrete_5Mstps", "total_steps=1152",
                    "algo.learning_starts=1024") + P2E_L_ENV_ARGS,
        exploration_counts=(72, 64, [8], 9, STAND_IN_EPISODE, None),
        finetuning_counts=(72, 0, [63, 9], 9, STAND_IN_EPISODE, 64),
        obs=DOAPP_P2E_OBS, actions=DOAPP_ACTIONS, bf16=True, algo="p2e_dv3",
    ),
}
# DreamerV1 and P2E-DV1: their recurrent core is flax's GRU cell, PyTorch operations on the card as in the
# JAX package (no Pallas kernel there, so none here), and every DV1 path must launch hafner_cell 0 times
DV1_TRAIN_STEPS = 4
# the card's step against the port's own CPU step on the same weights, batch and noise: full-width modules at a cut
# batch (B=8 x T=16, so that the CPU side takes seconds), TF32 off, losses within TOL_TRAIN_LOSS and the other metrics
# within TOL_TRAIN_GRAD, relative. The updates that precede later losses in the step (the world model's, P2E-DV1's
# ensemble's) run at learning rate 0 there: Adam's first update moves every parameter by about lr whatever the size
# of its gradient, so a rounding-sized gradient's sign flip moves it by 2 lr, and the imagination on the updated
# world model carries that into the actor's losses (the port's own CPU step in f32 against f64 at the preset's lr:
# 8.4e-5 relative on Loss/policy_loss; at lr 0: 3.4e-7)
DV1_CPU_OVERRIDES = {"per_rank_batch_size": 8, "per_rank_sequence_length": 16, "algo.world_model.optimizer.lr": 0.0}
# the DV1 run: exp=dreamer_v1 at its full width on the discrete dummy env (2 actions, 5-step episodes), 4 envs, the
# sequential buffer (checkpointed), log_level 1. Cuts: a buffer of 4096 steps (5e6), 768 policy steps (5e6), learning
# from 512 (5000), training every 128 policy steps (1000) for 8 gradient steps a burst (100), a log every 256
RUN_DV1_ARGS = (
    "exp=dreamer_v1", "env=dummy", "env.id=discrete_dummy", "env.sync_env=True", "buffer.size=4096",
    "buffer.checkpoint=True", "total_steps=768", "algo.learning_starts=512", "algo.train_every=128",
    "algo.per_rank_gradient_steps=8", "metric.log_every=256",
)
# P2E-DV1: exploration, then finetuning from its checkpoint, at exp=p2e_dv1_exploration's width. Cuts: a buffer of
# 4096 steps, 768 and 512 policy steps (5e6 and 1e6), learning from 512 and 256 (5000 both), training every 128
# (1000) for 4 gradient steps a burst (100)
P2E_DV1_ARGS = P2E_ENV_ARGS + ("algo.train_every=128", "algo.per_rank_gradient_steps=4")
RUN_P2E_SPECS["p2e_dv1"] = dict(
    exploration=("exp=p2e_dv1_exploration", "total_steps=768", "algo.learning_starts=512") + P2E_DV1_ARGS,
    finetuning=("exp=p2e_dv1_finetuning", "total_steps=512", "algo.learning_starts=256") + P2E_DV1_ARGS,
    exploration_counts=(192, 128, [64], 12, 5, None),
    finetuning_counts=(128, 0, [63, 65], 12, 5, 64),
    cell=False,
)
P2E_STEP_LAUNCHES["p2e_dv1"] = P2E_FINETUNING_STEP_LAUNCHES["p2e_dv1"] = 0
CLIENTS, STEPS, SEED = 64, 16, 5
N_ACTIONS = 9
OBS = {"rgb": (3, 64, 64)}
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, TF32 on them (dense), HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3  # hi.hi + hi.lo + lo.hi: f32 accuracy from TF32 operands
PEAK_HBM_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12  # bf16 on the tensor cores, dense, f32 accumulation
# the L and XL widths in f32 (no bias, LayerNorm, eps 1e-3): DreamerV3's DIAMBRA L preset (recurrent 2048 after a
# 768-wide pre-layer; its acting envs 8, the eval pool 10, the posterior 16, a serving batch 64, the imagination
# 16 x 64) and its Crafter XL preset (recurrent 4096, pre-layer 1024; 1 acting env)
LARGE_CELL_SHAPES = {
    "dv3_L": (2048, 768, (8, 10, 16, 64, 1024)),
    "dv3_XL": (4096, 1024, (1, 10, 16, 64, 1024)),
}
# the cell's bf16 operand path (fabric.precision=bf16-mixed): P2E-DV3's L DIAMBRA presets (recurrent 1024, pre-layer
# 768; acting 16 envs, the exploration posterior 4 and finetuning's 16, their imaginations 4 x 64 and 16 x 64, the eval
# pool 10, a serving batch 64) and DreamerV3 100k's width under bf16
# device_ms at the L and XL shapes: 5 calls a graph, 20 replays (a call at B=1024 reads 90-250 MB of W)
LARGE_TIMING = {"calls": 5, "n": 20}
BF16_CELL_SHAPES = {
    "p2e_dv3_L": (1024, 768, (4, 10, 16, 64, 256, 1024)),
    "dv3": (512, 512, (1, 16, 1024)),
}
# bf16 against the plain bf16 cell: both round h, x and W alike and accumulate in f32, so the outputs differ by the
# f32 summation order only (TOL_KERNEL); what flows back through a rounding to bf16 (dx, the product's part of dh, dW)
# can land one bf16 ulp apart, at most 2^-7 of the value: gradients within 2^-7 of their largest magnitude (read on
# an H100: 3.85e-3 at most). A bf16 train step, kernel
# against plain cell: the same 1e-6-sized differences now and then land on the other side of a bf16 rounding in the
# layers after the cell, and every later layer rounds again (about 1 in 800 straight-through samples is a near-tie
# that flips, pinned by _PinnedSamples), so losses, gradient norms and metrics within four bf16 roundings, 4 x 2^-8,
# relative (read on an H100: 3.9e-3 at most on a loss, 5.5e-3 on a near-zero mean of returns)
TOL_GRAD_BF16 = 2.0**-7
TOL_TRAIN_BF16 = 4 * 2.0**-8
# a bf16 checkpoint evaluated and served, kernel against plain cell: the plain path takes the kernel path's posterior
# samples and greedy actions (_PinnedSamples), whose near-ties bf16 rounding may flip (1 in 800 samples in training):
# at most 1% of them may; the recurrent states within one bf16 ulp at 1, 2^-7
TOL_FLIPS_BF16 = 0.01
TOL_STATE_BF16 = 2.0**-7


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def walker_stand_in(id="walker_walk", from_pixels=True, from_vectors=True, height=64, width=64, seed=None, **_):
    """A stand-in for dm_control's ``walker_walk`` (the card's machine has no
    dm_control), made by the walker run's env config
    (``env.wrapper._target_``) with the DMC wrapper's arguments: its spaces
    (``rgb`` uint8 3 x height x width; ``state`` f32 24: orientations 14,
    height 1, velocity 9; actions Box(-1, 1, (6,))), seeded random frames
    and states, rewards in [0, 1], no termination (the preset's TimeLimit
    truncates at 1000 steps). An action outside the Box raises."""
    import numpy as np

    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.wrappers import Env

    class WalkerStandIn(Env):
        def __init__(self):
            obs = {}
            if from_pixels:
                obs["rgb"] = spaces.Box(0, 255, (3, height, width), np.uint8)
            if from_vectors:
                obs["state"] = spaces.Box(-np.inf, np.inf, (WALKER_OBS["state"][0],), np.float32)
            self.observation_space = spaces.Dict(obs)
            self.action_space = spaces.Box(-1.0, 1.0, (WALKER_ACTIONS,), np.float32)
            self._rng = np.random.default_rng(seed)

        def _obs(self):
            out = {}
            if "rgb" in self.observation_space:
                out["rgb"] = self._rng.integers(0, 256, self.observation_space["rgb"].shape, dtype=np.uint8)
            if "state" in self.observation_space:
                out["state"] = self._rng.normal(size=self.observation_space["state"].shape).astype(np.float32)
            return out

        def reset(self, *, seed=None, options=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            return self._obs(), {}

        def step(self, action):
            action = np.asarray(action)
            if action.shape != (WALKER_ACTIONS,) or not np.isfinite(action).all() or np.abs(action).max() > 1.0:
                raise ValueError(f"the walker stand-in got an action outside Box(-1, 1, (6,)): {action}")
            return self._obs(), float(self._rng.random()), False, False, {"discount": 1.0}

    return WalkerStandIn()


def _stand_in_env(obs_spaces, action_n: int, seed):
    """A seeded env of the port's spaces: random frames and vector keys in
    their boxes, rewards in [0, 1), an episode terminated every
    STAND_IN_EPISODE steps; a discrete action outside ``[0, action_n)``
    raises."""
    import numpy as np

    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.wrappers import Env

    class StandIn(Env):
        def __init__(self):
            self.observation_space = spaces.Dict(obs_spaces)
            self.action_space = spaces.Discrete(action_n)
            self._rng = np.random.default_rng(seed)
            self._t = 0

        def _obs(self):
            out = {}
            for k, space in self.observation_space.spaces.items():
                lo, hi = np.broadcast_to(space.low, space.shape), np.broadcast_to(space.high, space.shape)
                out[k] = self._rng.integers(lo, hi, endpoint=True, dtype=np.int64).astype(space.dtype)
            return out

        def reset(self, *, seed=None, options=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self._t = 0
            return self._obs(), {}

        def step(self, action):
            a = np.asarray(action)
            if a.size != 1 or not 0 <= int(a.reshape(())) < action_n:
                raise ValueError(f"the stand-in got an action outside Discrete({action_n}): {action}")
            self._t += 1
            return self._obs(), float(self._rng.random()), self._t >= STAND_IN_EPISODE, False, {}

    return StandIn()


def doapp_spaces(screen_size=64, grayscale=False):
    """The DIAMBRA wrapper's observation spaces for Dead or Alive++
    (DOAPP_RAW_KEYS, and the frame ``(H, W, 1)`` grey or ``(H, W, 3)``
    uint8, as the engine resizes it), as the port's spaces."""
    import numpy as np

    from sheeprl_tpu_torch.envs import spaces

    size = (screen_size, screen_size) if isinstance(screen_size, int) else tuple(screen_size)
    out = {"frame": spaces.Box(0, 255, size + (1 if grayscale else 3,), np.uint8)}
    for k, (kind, *args) in DOAPP_RAW_KEYS.items():
        low, high = (0, args[0] - 1) if kind == "discrete" else args
        out[k] = spaces.Box(low, high, (1,), np.int32)
    return out


def doapp_stand_in(id="doapp", action_space="diambra.arena.SpaceTypes.DISCRETE", screen_size=64, grayscale=False,
                   rank=None, seed=None, **_):
    """A stand-in for DIAMBRA's Dead or Alive++ (the card's machine has no
    diambra), made by the DIAMBRA runs' env config (``env.wrapper._target_``)
    with the DIAMBRA wrapper's arguments: its spaces (``doapp_spaces``) and
    the combo-discrete action, Discrete(DOAPP_ACTIONS); seeded from the env's
    rank."""
    if not str(action_space).endswith("DISCRETE") or str(action_space).endswith("MULTI_DISCRETE"):
        raise ValueError(f"the doapp stand-in has the combo-discrete action space only, got {action_space}")
    return _stand_in_env(doapp_spaces(screen_size, grayscale), DOAPP_ACTIONS, seed if seed is not None else rank)


def crafter_spaces(screen_size=64):
    """The Crafter wrapper's observation space (sheeprl_tpu/envs/crafter.py:29-32:
    ``rgb``, crafter's ``(H, W, 3)`` uint8 frame), as the port's spaces."""
    import numpy as np

    from sheeprl_tpu_torch.envs import spaces

    size = (screen_size, screen_size) if isinstance(screen_size, int) else tuple(screen_size)
    return {"rgb": spaces.Box(0, 255, size + (3,), np.uint8)}


def crafter_stand_in(id="crafter_reward", screen_size=64, seed=None, **_):
    """A stand-in for Crafter (the card's machine has no crafter), made by
    the Crafter runs' env config with the Crafter wrapper's arguments: its
    spaces (``crafter_spaces``) and Discrete(CRAFTER_ACTIONS)."""
    return _stand_in_env(crafter_spaces(screen_size), CRAFTER_ACTIONS, seed)


def _median_event_ms(run, n: int) -> float:
    import torch

    pairs = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def call_ms(fn, n: int = 200, warmup: int = 20) -> float:
    """Median time of one eager call as a caller pays it: an event pair
    around each of ``n`` back-to-back calls (host launch gaps included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _median_event_ms(fn, n)


def device_ms(fn, calls: int = 20, n: int = 50) -> float:
    """Median device time of one call: ``calls`` back-to-back calls of
    ``fn`` captured in one CUDA graph, an event pair around each of ``n``
    replays, divided by ``calls``. Before each replay the stream is kept
    busy (``torch.cuda._sleep``) so that the start event runs only after the
    host has queued the graph: the host's launch cost stays out of the
    measurement. The operands stay in the 50 MB L2 from call to call."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    from sheeprl_tpu_torch.train.graphs import capture_guard

    graph = torch.cuda.CUDAGraph()
    with capture_guard(), torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()

    pairs = []
    for _ in range(n):
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / calls


def _bound(bytes_: float, product_flops: float, other_flops: float):
    """``(bound_ms, bound_by, bound_f32_simt_ms)``: the larger of the bytes
    at the HBM rate and the operations (the product in TF32_PASSES passes on
    the tensor cores, the rest at the f32 rate); and the earlier convention,
    every operation at the f32 rate."""
    t_bytes = bytes_ / PEAK_HBM_BYTES
    t_ops = TF32_PASSES * product_flops / PEAK_TF32_FLOPS + other_flops / PEAK_F32_FLOPS
    t_simt = (product_flops + other_flops) / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), 1e3 * max(t_bytes, t_simt)


def hafner_bound(B: int, H: int, X: int, bias: bool, ln: bool):
    """Least time for one step (``_bound``): each input read once and the
    output written once, or the operations."""
    n_vec = 3 * H * (int(bias) + 2 * int(ln))
    bytes_ = 4.0 * (B * H + B * X + (H + X) * 3 * H + n_vec + B * H)
    other = (8.0 * B * 3 * H if ln else 0.0) + 10.0 * B * H
    return _bound(bytes_, 2.0 * B * (H + X) * 3 * H, other)


def phase_kernels():
    import numpy as np
    import torch

    from sheeprl_tpu_torch.kernels import ops, reference

    # the served widths at the batch sizes of one client (and the run's test episode), the run's
    # player (4 envs), a part-filled batch (the run's 16 served clients) and a full one; then odd
    # widths without bias and LayerNorm (scalar copies)
    cases = [(B, 600, 400, True, True) for B in (1, 4, 16, 64)] + [(B, 599, 37, False, False) for B in (1, 5, 64)]
    rows = []
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for B, H, X, bias, ln in cases:
            rng = np.random.RandomState(B * 1000 + H)
            t = lambda *shape, scale=1.0: torch.from_numpy(
                (scale * rng.randn(*shape)).astype(np.float32)
            ).cuda()
            h, x, w = t(B, H), t(B, X), t(H + X, 3 * H, scale=0.05)
            b = t(3 * H, scale=0.1) if bias else None
            s = (1.0 + t(3 * H, scale=0.1)) if ln else None
            lb = t(3 * H, scale=0.1) if ln else None
            out = ops.hafner_cell_cuda(h, x, w, b, s, lb, eps=1e-5)
            torch.cuda.synchronize()
            plain = reference.hafner_cell(h, x, w, b, s, lb, eps=1e-5)
            err = (out - plain).abs().max().item()
            ok = bool(torch.isfinite(out).all().item()) and err <= TOL_KERNEL
            kernel = lambda: ops.hafner_cell_cuda(h, x, w, b, s, lb, eps=1e-5)
            plain_fn = lambda: reference.hafner_cell(h, x, w, b, s, lb, eps=1e-5)
            bound_ms, bound_by, simt_ms = hafner_bound(B, H, X, bias, ln)
            row = dict(B=B, H=H, X=X, bias=bias, ln=ln, max_abs_err=err, tol=TOL_KERNEL,
                       ms=device_ms(kernel), plain_ms=device_ms(plain_fn),
                       call_ms=call_ms(kernel), plain_call_ms=call_ms(plain_fn),
                       bound_ms=bound_ms, bound_by=bound_by, bound_f32_simt_ms=simt_ms,
                       variant=ops.hafner_cell_variant(B, H, X))
            if (B, H, X) == (64, 600, 400):
                row.update(product_split((h, x, w, b, s, lb), B))
            print("[kernel] hafner_cell " + json.dumps(row), flush=True)
            rows.append(row)
            if not ok:
                raise AssertionError(f"hafner_cell disagrees with its plain version: {row}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return rows


def sequence_bound(T: int, B: int, H: int, X: int, bias: bool, ln: bool):
    """Least time for a whole sequence (``_bound``): xs, h0, W and the
    vectors read once and hs written once, or T steps of operations."""
    n_vec = 3 * H * (int(bias) + 2 * int(ln))
    bytes_ = 4.0 * (B * H + T * B * X + (H + X) * 3 * H + n_vec + T * B * H)
    other = T * ((8.0 * B * 3 * H if ln else 0.0) + 10.0 * B * H)
    return _bound(bytes_, T * 2.0 * B * (H + X) * 3 * H, other)


def saved_z_error(args) -> dict:
    """The pre-activation the cell keeps for its gradient against float64,
    beside cuBLAS's f32 product of the same ``[h|x]·W + b`` (TF32 off): the
    3xTF32 product's error next to an f32 FMA chain's."""
    import torch

    from sheeprl_tpu_torch.kernels import ops

    h, x, w, b = args[:4]
    _out, z = ops.hafner_cell_cuda(*args, eps=1e-5, save_z=True)
    u = torch.cat([h, x], dim=-1)
    z64 = u.double() @ w.double() + b.double()
    return {
        "z_max_abs": z64.abs().max().item(),
        "z_err_vs_f64": (z.double() - z64).abs().max().item(),
        "cublas_z_err_vs_f64": ((u @ w + b).double() - z64).abs().max().item(),
    }


def product_split(args, B: int) -> dict:
    """The cell's device time split into its product and gate kernels (the
    profiler's kernel records, as ``tools/bench_cell.py`` reads them), and
    cuBLAS's f32 SGEMM of the same ``[h|x]·W`` (``torch.matmul``, TF32 off;
    on the bf16 operand path its GEMM on bf16 operands),
    timed as every kernel here (``device_ms``). In ms."""
    import torch

    from sheeprl_tpu_torch.tools import bench_cell

    split = bench_cell.cell_split(args)
    h, x, w = args[:3]
    if x.dtype == torch.bfloat16:  # the bf16 operand path: cuBLAS's GEMM on bf16 operands, one pass
        h, w = h.to(torch.bfloat16), w.to(torch.bfloat16)
    u = torch.cat([h, x], dim=-1)
    flops = 2.0 * B * u.shape[1] * w.shape[1]
    out = {
        "product_ms": split["product_us"] / 1e3,
        "gates_ms": split["gates_us"] / 1e3,
        "cublas_product_ms": device_ms(lambda: torch.matmul(u, w)),
        "cublas_product_profiler_ms": split["cublas_product_us"] / 1e3,
    }
    if x.dtype == torch.bfloat16:
        out["product_tflops_bf16"] = flops / (split["product_us"] * 1e6)
    else:
        out["product_tflops_tf32"] = TF32_PASSES * flops / (split["product_us"] * 1e6)
    return out


def _grad_rel_err(got, want) -> float:
    """Largest abs difference of any gradient over that gradient's largest
    magnitude (gradients of W sum over the batch, so their scale grows with B)."""
    return max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item() for g, w in zip(got, want))


def _operands(shape_seed: int, B: int, H: int, X: int, bias: bool, ln: bool, T: int = 0):
    import numpy as np
    import torch

    rng = np.random.RandomState(shape_seed)
    t = lambda *shape, scale=1.0, shift=0.0: torch.from_numpy(
        (shift + scale * rng.randn(*shape)).astype(np.float32)
    ).cuda()
    h = t(B, H)
    x = t(T, B, X) if T else t(B, X)
    w = t(H + X, 3 * H, scale=0.05)
    b = t(3 * H, scale=0.1) if bias else None
    s = t(3 * H, scale=0.1, shift=1.0) if ln else None
    lb = t(3 * H, scale=0.1) if ln else None
    cot = t(T, B, H) if T else t(B, H)  # the output cotangent of the gradient check
    return (h, x, w, b, s, lb), cot


def _vjp(fn, args, cot):
    """Gradients of <fn(*args), cot> with respect to every operand given."""
    import torch

    leaves = [a.detach().requires_grad_(True) if a is not None else None for a in args]
    out = fn(*leaves)
    present = [a for a in leaves if a is not None]
    return out.detach(), torch.autograd.grad(out, present, cot)


def phase_cell_training():
    """The cell at the training batch sizes (posterior B=32, an odd B, the
    imagination's B=1600): forward against the plain version, the hand VJP's
    six gradients against autograd of the plain version, both on the card."""
    import torch

    from sheeprl_tpu_torch.kernels import ops, reference

    rows = []
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for B in (32, 801, 1600):
            H, X = 600, 400
            args, cot = _operands(B + 7, B, H, X, True, True)
            kernel = lambda *a: ops.hafner_gru_cell(*a, eps=1e-5)
            plain = lambda *a: reference.hafner_cell(*a, eps=1e-5)
            out, grads = _vjp(kernel, args, cot)
            p_out, p_grads = _vjp(plain, args, cot)
            torch.cuda.synchronize()
            err = (out - p_out).abs().max().item()
            grad_err = _grad_rel_err(grads, p_grads)
            bound_ms, bound_by, simt_ms = hafner_bound(B, H, X, True, True)
            leaves = [a.detach().requires_grad_(True) for a in args]
            row = dict(B=B, H=H, X=X, eps=1e-5, max_abs_err=err, tol=TOL_KERNEL, grad_rel_err=grad_err,
                       grad_tol=TOL_GRAD, ms=device_ms(lambda: ops.hafner_cell_cuda(*args, eps=1e-5)),
                       plain_ms=device_ms(lambda: reference.hafner_cell(*args, eps=1e-5)),
                       fwd_bwd_ms=device_ms(lambda: torch.autograd.grad(kernel(*leaves), leaves, cot)),
                       plain_fwd_bwd_ms=device_ms(lambda: torch.autograd.grad(plain(*leaves), leaves, cot)),
                       bound_ms=bound_ms, bound_by=bound_by, bound_f32_simt_ms=simt_ms,
                       variant=ops.hafner_cell_variant(B, H, X))
            if B in (32, 1600):
                row.update(product_split(args, B))
            row.update(saved_z_error(args))
            print("[kernel] hafner_cell training " + json.dumps(row), flush=True)
            rows.append(row)
            if not (torch.isfinite(out).all() and err <= TOL_KERNEL and grad_err <= TOL_GRAD):
                raise AssertionError(f"hafner_cell at B={B} disagrees with its plain version: {row}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return rows


def _cell_shape_rows(label: str, H: int, X: int, bias: bool, eps: float, batches, vjp_batches, split_batch: int,
                     timing=None):
    """The cell at one model's shapes (H, X, bias, LayerNorm, eps) at the
    batches of its paths: forward against the plain version, the hand VJP's
    gradients (five without bias, six with) against autograd of the plain
    version, the variant the plan launches, device time beside the plain
    version's, the bound and cuBLAS's f32 SGEMM of the same product; at
    ``split_batch`` also the time split into product and gates, and at
    ``vjp_batches`` the VJP's times (``vjp_times``). ``timing`` overrides
    ``device_ms``'s calls a graph and replays."""
    import torch

    from sheeprl_tpu_torch.kernels import ops, reference

    rows = []
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for B in batches:
            args, cot = _operands(B + 11, B, H, X, bias, True)
            kernel = lambda *a: ops.hafner_gru_cell(*a, eps=eps)
            plain = lambda *a: reference.hafner_cell(*a, eps=eps)
            out, grads = _vjp(kernel, args, cot)
            p_out, p_grads = _vjp(plain, args, cot)
            torch.cuda.synchronize()
            err = (out - p_out).abs().max().item()
            grad_err = _grad_rel_err(grads, p_grads)
            bound_ms, bound_by, simt_ms = hafner_bound(B, H, X, bias=bias, ln=True)
            u = torch.cat(args[:2], dim=-1)
            row = dict(B=B, H=H, X=X, bias=bias, ln=True, eps=eps, max_abs_err=err, tol=TOL_KERNEL,
                       grad_rel_err=grad_err, grad_tol=TOL_GRAD, gradients=len(grads),
                       ms=device_ms(lambda: ops.hafner_cell_cuda(*args, eps=eps), **timing or {}),
                       plain_ms=device_ms(lambda: reference.hafner_cell(*args, eps=eps), **timing or {}),
                       cublas_product_ms=device_ms(lambda: torch.matmul(u, args[2]), **timing or {}),
                       bound_ms=bound_ms, bound_by=bound_by, bound_f32_simt_ms=simt_ms,
                       variant=ops.hafner_cell_variant(B, H, X))
            if B == split_batch:
                row.update(product_split(args, B))
            if B in vjp_batches:
                row["vjp"] = vjp_times(args, cot, eps, timing)
            print(f"[kernel] hafner_cell {label} " + json.dumps(row), flush=True)
            rows.append(row)
            grid = row["variant"]["grid"]
            if len(grads) != 5 + int(bias) or grid[1] * row["variant"]["tile_rows"] < B or grid[0] * 64 * row["variant"]["warpgroups"] < 3 * H:
                raise AssertionError(f"the cell at B={B} returned {len(grads)} gradients, variant {row['variant']}")
            if not (torch.isfinite(out).all() and err <= TOL_KERNEL and grad_err <= TOL_GRAD):
                raise AssertionError(f"hafner_cell at {label}'s B={B} disagrees with its plain version: {row}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return rows


def phase_cell_dv3():
    """The cell at DreamerV3's shapes (H = X = 512, no bias, LayerNorm, eps
    1e-3) at the batches of its paths (DV3_CELL_BATCHES), with the VJP at
    the posterior's B=16 (with the weight gradient) and the imagination's
    B=1024 (without), and the product and gates apart at B=1024."""
    return _cell_shape_rows("dv3", DV3_H, DV3_X, False, DV3_EPS, DV3_CELL_BATCHES,
                            [B for B in DV3_CELL_BATCHES if B > 1], max(DV3_CELL_BATCHES))


def phase_cell_p2e():
    """The cell at Plan2Explore's presets' shapes (P2E_CELL_SHAPES: P2E-DV3 at
    H = X = 256 without bias, eps 1e-3; P2E-DV2 at H = X = 400 with bias,
    eps 1e-5) at the batches of their paths, with the VJP at the posterior's
    and the imagination's batches and the product and gates apart at the
    imagination's. Returns the rows by preset."""
    return {name: _cell_shape_rows(name, H, X, bias, eps, batches, (16, max(batches)), max(batches))
            for name, (H, X, bias, eps, batches) in P2E_CELL_SHAPES.items()}


def phase_cell_large():
    """The cell at the L and XL widths in f32 (LARGE_CELL_SHAPES: H = 2048, X
    = 768 and H = 4096, X = 1024, no bias, eps 1e-3) at the batches of their
    paths, with the VJP at the posterior's B=16 and the imagination's B=1024
    and the product and gates apart at B=1024. Returns the rows by preset."""
    return {name: _cell_shape_rows(name, H, X, False, DV3_EPS, batches, (16, max(batches)), max(batches),
                                   timing=LARGE_TIMING)
            for name, (H, X, batches) in LARGE_CELL_SHAPES.items()}


def hafner_bound_bf16(B: int, H: int, X: int, bias: bool, ln: bool):
    """Least time for one step on the bf16 operand path: the bytes the kernel
    reads and writes (h, W and the vectors in f32, x in bf16, the new h in
    f32) at the HBM rate, or the product in one bf16 pass on the tensor cores
    plus the LayerNorm and gates at the f32 rate."""
    n_vec = 3 * H * (int(bias) + 2 * int(ln))
    bytes_ = 4.0 * (B * H + (H + X) * 3 * H + n_vec + B * H) + 2.0 * B * X
    other = (8.0 * B * 3 * H if ln else 0.0) + 10.0 * B * H
    t_bytes = bytes_ / PEAK_HBM_BYTES
    t_ops = 2.0 * B * (H + X) * 3 * H / PEAK_BF16_FLOPS + other / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _cell_bf16_rows(label: str, H: int, X: int, batches, vjp_batches, split_batch: int):
    """The cell's bf16 operand path at one preset's shapes (no bias,
    LayerNorm, eps 1e-3; x in bf16) at the batches of its paths: forward
    against the plain bf16 cell (TOL_KERNEL), the hand VJP's five gradients
    against autograd of the plain bf16 cell (TOL_GRAD_BF16), the variant,
    device time beside the plain version's, the bound (``hafner_bound_bf16``)
    and cuBLAS's GEMM of the same product on bf16 operands (``torch.matmul``);
    the product and gates apart at ``split_batch``, the VJP's times at
    ``vjp_batches``."""
    import torch

    from sheeprl_tpu_torch.kernels import ops, reference

    bf = torch.bfloat16
    rows = []
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for B in batches:
            (h, x, w, b, s, lb), cot = _operands(B + 13, B, H, X, False, True)
            args = (h, x.to(bf), w, b, s, lb)
            kernel = lambda *a: ops.hafner_gru_cell(*a, eps=DV3_EPS)
            plain = lambda *a: reference.hafner_cell(*a, eps=DV3_EPS)
            before = ops.hafner_cell_launches.by_variant.get("bf16", 0)
            out, grads = _vjp(kernel, args, cot)
            if ops.hafner_cell_launches.by_variant.get("bf16", 0) != before + 1:
                raise AssertionError(f"the bf16 cell at B={B} did not launch its bf16 variant")
            p_out, p_grads = _vjp(plain, args, cot)
            torch.cuda.synchronize()
            err = (out - p_out).abs().max().item()
            grad_err = _grad_rel_err([g.float() for g in grads], [g.float() for g in p_grads])
            bound_ms, bound_by = hafner_bound_bf16(B, H, X, bias=False, ln=True)
            ub, wb = torch.cat([h.to(bf), args[1]], dim=-1), w.to(bf)  # cuBLAS's product on bf16 operands
            row = dict(B=B, H=H, X=X, bias=False, ln=True, eps=DV3_EPS, operands="bf16", max_abs_err=err,
                       tol=TOL_KERNEL, grad_rel_err=grad_err, grad_tol=TOL_GRAD_BF16, gradients=len(grads),
                       dx_dtype=str(grads[1].dtype), out_dtype=str(out.dtype),
                       ms=device_ms(lambda: ops.hafner_cell_cuda(*args, eps=DV3_EPS)),
                       plain_ms=device_ms(lambda: reference.hafner_cell(*args, eps=DV3_EPS)),
                       cublas_product_ms=device_ms(lambda: torch.matmul(ub, wb)),
                       bound_ms=bound_ms, bound_by=bound_by,
                       variant=ops.hafner_cell_variant(B, H, X, dtype=bf))
            if B == split_batch:
                row.update(product_split(args, B))
            if B in vjp_batches:
                row["vjp"] = vjp_times(args, cot, DV3_EPS)
            print(f"[kernel] hafner_cell bf16 {label} " + json.dumps(row), flush=True)
            rows.append(row)
            if len(grads) != 5 or out.dtype != torch.float32 or grads[1].dtype != bf or "bf16" not in row["variant"]["product"]:
                raise AssertionError(f"the bf16 cell at B={B}: {len(grads)} gradients, {row}")
            if not (torch.isfinite(out).all() and err <= TOL_KERNEL and grad_err <= TOL_GRAD_BF16):
                raise AssertionError(f"the bf16 cell at {label}'s B={B} disagrees with the plain bf16 cell: {row}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return rows


def phase_cell_bf16():
    """The cell's bf16 operand path at BF16_CELL_SHAPES, the VJP at the
    posterior's B=16 and the largest imagination batch, the product and
    gates apart there. Returns the rows by preset."""
    return {name: _cell_bf16_rows(name, H, X, batches, (16, max(batches)), max(batches))
            for name, (H, X, batches) in BF16_CELL_SHAPES.items()}


def vjp_bound(B: int, H: int, X: int, weight_grad: bool):
    """Least time of the cell's VJP without bias (``_bound``): z, h, the
    cotangent, W and the LayerNorm vectors read once, dh, dx and the
    LayerNorm gradients written once (with the weight gradient also x read
    and dW written); the input product ``dz·Wᵀ`` (and ``[h|x]ᵀ·dz``) at f32
    accuracy on the tensor cores, and at the f32 rate the LayerNorm
    recomputed from z (8 operations an element of z, as the forward counts
    it), its backward (10 an element of z) and the gates' backward (20 an
    element of h)."""
    vectors = 2 * 3 * H
    bytes_ = 4.0 * (B * 3 * H + 2 * B * H + (H + X) * 3 * H + vectors + B * H + B * X + vectors)
    product = 2.0 * B * (H + X) * 3 * H
    if weight_grad:
        bytes_ += 4.0 * (B * X + (H + X) * 3 * H)
        product *= 2
    return _bound(bytes_, product, 18.0 * B * 3 * H + 20.0 * B * H)


def vjp_times(args, cot, eps: float = DV3_EPS, timing=None) -> dict:
    """The cell's hand VJP (``ops.hafner_cell_vjp``, plain PyTorch
    operations) at the kernel's kept pre-activation: as DreamerV3's
    continuous imagination runs it (dh and dx: the world model is frozen
    while the actor's loss is differentiated) and with the weight gradient
    (the posterior's), device time beside the kernel forward's and the
    bounds."""
    from sheeprl_tpu_torch.kernels import ops

    h, x, w, b, s, lb = args
    B, H, X = h.shape[0], h.shape[1], x.shape[1]
    _out, z = ops.hafner_cell_cuda(h, x, w, b, s, lb, eps=eps, save_z=True)
    inputs = lambda: ops.hafner_cell_vjp(h, x, w, b, s, lb, z, cot, eps, need=(True, True, False, False))
    full = lambda: ops.hafner_cell_vjp(h, x, w, b, s, lb, z, cot, eps)
    bound_ms, bound_by, simt_ms = vjp_bound(B, H, X, weight_grad=False)
    full_bound_ms, full_bound_by, _ = vjp_bound(B, H, X, weight_grad=True)
    timing = timing or {}
    return {"B": B, "H": H, "X": X, "bias": b is not None,
            "forward_ms": device_ms(lambda: ops.hafner_cell_cuda(h, x, w, b, s, lb, eps=eps), **timing),
            "ms": device_ms(inputs, **timing), "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_f32_simt_ms": simt_ms, "with_weight_grad_ms": device_ms(full, **timing),
            "with_weight_grad_bound_ms": full_bound_ms,
            "with_weight_grad_bound_by": full_bound_by}


def phase_sequence():
    """The sequence kernel at SEQUENCE_SHAPES: the variant its plan picks,
    forward and gradients against the plain loop under autograd, device
    time, bound and plain time; then each variant that fits launched by name
    (forward against the plain loop, device time, device launches per call
    and the time split into input projection and recurrence from the
    profiler's kernel records) and, where the persistent recurrence runs,
    its synchronisation alone a step (``ops.hafner_sync_floor_cuda``)."""
    import torch

    from sheeprl_tpu_torch.kernels import ops, reference
    from sheeprl_tpu_torch.tools import bench_kernels

    rows = []
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for T, B, H, X, bias, ln, eps, expected in SEQUENCE_SHAPES:
            args, cot = _operands(T + B + H, B, H, X, bias, ln, T=T)
            plan = ops.hafner_sequence_variant(T, B, H, X)
            if plan["variant"] != expected:
                raise AssertionError(f"the plan at T={T} B={B} H={H} X={X} picks {plan['variant']}, not {expected}")
            kernel = lambda *a: ops.hafner_gru_sequence(*a, eps=eps)
            plain = lambda *a: reference.hafner_sequence(*a, eps=eps)
            before = ops.hafner_sequence_launches.count
            before_variant = ops.hafner_sequence_launches.by_variant.get(expected, 0)
            out, grads = _vjp(kernel, args, cot)
            p_out, p_grads = _vjp(plain, args, cot)
            torch.cuda.synchronize()
            if (ops.hafner_sequence_launches.count != before + 1
                    or ops.hafner_sequence_launches.by_variant[expected] != before_variant + 1):
                raise AssertionError(f"hafner_gru_sequence did not launch its {expected} kernel exactly once")
            err = (out - p_out).abs().max().item()
            grad_err = _grad_rel_err(grads, p_grads)
            bound_ms, bound_by, simt_ms = sequence_bound(T, B, H, X, bias, ln)
            variants = {}
            for variant in ("persistent", "multi_launch") if expected == "persistent" else ("multi_launch",):
                hs = ops.hafner_sequence_cuda(*args, eps=eps, variant=variant)
                torch.cuda.synchronize()
                variants[variant] = {
                    "max_abs_err": (hs - p_out).abs().max().item(),
                    "ms": device_ms(lambda: ops.hafner_sequence_cuda(*args, eps=eps, variant=variant)),
                    **bench_kernels.sequence_split(args, variant, eps),
                }
            chosen = variants[expected]
            row = dict(T=T, B=B, H=H, X=X, bias=bias, ln=ln, eps=eps, max_abs_err=err, tol=TOL_SEQUENCE,
                       grad_rel_err=grad_err, grad_tol=TOL_GRAD, variant=expected,
                       ms=device_ms(lambda: ops.hafner_sequence_cuda(*args, eps=eps)),
                       plain_ms=device_ms(lambda: reference.hafner_sequence(*args, eps=eps)),
                       bound_ms=bound_ms, bound_by=bound_by, bound_f32_simt_ms=simt_ms,
                       device_launches_per_call=chosen["device_launches_per_call"],
                       projection_ms=chosen["projection_ms"], recurrence_ms=chosen["recurrence_ms"],
                       variants=variants, plan=plan)
            if expected == "persistent":
                floor_ms = device_ms(lambda: ops.hafner_sync_floor_cuda(B, H, SYNC_FLOOR_STEPS))
                row["sync_floor_us_per_step"] = 1e3 * floor_ms / SYNC_FLOOR_STEPS
            print("[kernel] hafner_sequence " + json.dumps(row), flush=True)
            rows.append(row)
            worst = max([err] + [v["max_abs_err"] for v in variants.values()])
            if not (torch.isfinite(out).all() and worst <= TOL_SEQUENCE and grad_err <= TOL_GRAD):
                raise AssertionError(f"hafner_sequence disagrees with its plain loop: {row}")
            if chosen["device_launches_per_call"] != plan["device_launches_per_call"]:
                raise AssertionError(f"the profiler counts {chosen['device_launches_per_call']} device launches "
                                     f"a call, the plan {plan['device_launches_per_call']}: {row}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return rows


def serve_lockstep(model, frames, seed: int):
    """C clients x T lockstep requests (``frames``: each observation key's
    ``[T, C, ...]``) through a fresh gateway with ``max_batch=C``; every step
    is one full batch, rows in client order (checked). Returns actions [T, C, heads]
    (indices, or floats for continuous actions), recurrent states [T, C, H]
    (host copies), wall seconds and the status."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.serve import ServeClosed, ServeGateway

    steps, clients = next(iter(frames.values())).shape[:2]
    # a deadline far past a step's submissions: each step dispatches as one full batch once its last row is in,
    # whatever pauses the submitting thread (a partial batch would shift every later draw of the noise)
    gateway = ServeGateway(model, max_batch=clients, deadline_s=60.0, seed=seed)
    try:
        batcher = gateway.batcher
        ids = [gateway.client(f"client{c}").client_id for c in range(clients)]
        actions = []
        states = []
        t0 = time.perf_counter()
        for t in range(steps):
            tickets = [batcher.submit(cid, {k: v[t, c] for k, v in frames.items()}, reset=t == 0)
                       for c, cid in enumerate(ids)]
            actions.append([np.asarray(batcher.wait(ticket, timeout=120.0)[0]).reshape(-1) for ticket in tickets])
            states.append(torch.cat([batcher.state_of(cid)["recurrent"] for cid in ids]).cpu())
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not gateway.drain(timeout=60.0):
            raise AssertionError("gateway did not drain")
        if gateway.status()["batches"] != steps:
            raise AssertionError(f"{steps} lockstep steps ran as {gateway.status()['batches']} batches")
        try:
            batcher.submit(ids[0], {k: v[0, 0] for k, v in frames.items()})
            raise AssertionError("a drained gateway accepted a request")
        except ServeClosed:
            pass
        return np.asarray(actions), torch.stack(states), wall, gateway.status()
    finally:
        gateway.close()


def eval_policy_lockstep(ckpt: str, frames, seed: int):
    """The evaluation policy of ``ckpt`` (its algorithm's registered eval
    builder, as ``cli.evaluation`` builds it) acting on ``frames`` (each key's
    ``[T, C, ...]``) as ``serve_lockstep``'s gateway batches them: C rows a
    step in client order, fresh state from one row repeated, the noise from
    one generator seeded ``seed`` on the card. Returns actions [T, C, heads]
    and recurrent states [T, C, H] (host copies), to hold a server's against."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.ckpt import read_checkpoint
    from sheeprl_tpu_torch.cli import load_run_config
    from sheeprl_tpu_torch.evals.service import _builder_for, fresh_state, probe_spaces

    cfg, _log_dir = load_run_config(ckpt)
    cfg.env.capture_video = False
    observation_space, action_space = probe_spaces(cfg)
    policy = _builder_for(cfg.algo.name)(None, cfg, read_checkpoint(ckpt, with_rb=False), observation_space,
                                         action_space, device="cuda")
    steps, clients = next(iter(frames.values())).shape[:2]
    generator = torch.Generator(device="cuda").manual_seed(seed)
    state = fresh_state(policy.init_state, clients)
    actions, states = [], []
    for t in range(steps):
        out, state = policy.act({k: v[t] for k, v in frames.items()}, state, generator)
        actions.append(np.asarray(out).reshape(clients, -1))
        states.append(state["recurrent"].cpu())
    return np.asarray(actions), torch.stack(states)


def phase_slice(card: str):
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
    from sheeprl_tpu_torch.configs import dreamer_v2_config
    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.serve import GatewayModel

    cfg = dreamer_v2_config()
    wm, actor = build_agent(cfg, (N_ACTIONS,), False, OBS, device="cuda")
    params = {"world_model": wm.state_dict(), "actor": actor.state_dict()}
    n_params = sum(p.numel() for p in list(wm.parameters()) + list(actor.parameters()))
    model = GatewayModel.from_params(params, cfg, OBS, (N_ACTIONS,), False, device="cuda", version=1)
    plain = GatewayModel.from_params(
        params, cfg, OBS, (N_ACTIONS,), False, device="cuda", version=1, plain_cell=True
    )
    rng = np.random.RandomState(SEED)
    frames = {"rgb": rng.randint(0, 256, (STEPS, CLIENTS) + OBS["rgb"]).astype(np.uint8)}
    serve_lockstep(model, {"rgb": frames["rgb"][:2]}, seed=SEED + 1)  # warm-up: cuDNN, allocator, kernel load

    ops.hafner_cell_launches.reset()
    ops.hafner_sequence_launches.reset()
    actions, states, wall, status = serve_lockstep(model, frames, seed=SEED)
    launches = ops.hafner_cell_launches.count
    seq_launches = ops.hafner_sequence_launches.count

    requests = CLIENTS * STEPS
    if status["failed_requests"] != 0 or status["requests"] != requests:
        raise AssertionError(f"served {status['requests']} requests, {status['failed_requests']} failed")
    if not ((actions >= 0) & (actions < N_ACTIONS)).all():
        raise AssertionError("an action is outside [0, 9)")
    if not torch.isfinite(states).all():
        raise AssertionError("a recurrent state is not finite")
    unchanged = (states[1:] == states[:-1]).all(dim=-1)
    if unchanged.any():
        raise AssertionError(f"{int(unchanged.sum())} client steps left the recurrent state unchanged")
    if launches != status["batches"] or launches == 0:
        raise AssertionError(f"hafner_cell launched {launches} times for {status['batches']} batches")
    if seq_launches != 0:
        raise AssertionError(f"the sequence kernel launched {seq_launches} times on the serving path")

    p_actions, p_states, _wall, p_status = serve_lockstep(plain, frames, seed=SEED)
    state_err = (states - p_states).abs().max().item()
    if p_status["failed_requests"] != 0 or not np.array_equal(actions, p_actions):
        raise AssertionError(f"kernel and plain paths disagree on {(actions != p_actions).sum()} actions")
    if state_err > TOL_STATE:
        raise AssertionError(f"recurrent state differs by {state_err} > {TOL_STATE}")
    lat = status["act_latency"]
    result = {
        "requests": requests,
        "clients": CLIENTS,
        "batches": status["batches"],
        "mean_batch_occupancy": status["mean_batch_occupancy"],
        "failed_requests": status["failed_requests"],
        "requests_per_s": requests / wall,
        "act_latency_p50_ms": lat["p50_ms"],
        "act_latency_p99_ms": lat["p99_ms"],
        "device_dispatch_p50_ms": status["stage_latency"]["device_dispatch"]["p50_ms"],
        "hafner_cell_launches": launches,
        "hafner_sequence_launches": seq_launches,
        "plain_replay_actions_equal": True,
        "plain_replay_state_max_abs_err": state_err,
        "state_tol": TOL_STATE,
        "params": n_params,
        "card": card,
    }
    print("[slice] " + json.dumps(result), flush=True)
    return {"hafner_cell": launches, "hafner_sequence": seq_launches}


def phase_bench_kernels():
    """The kernel bench's path: counts zeroed before it and read after it."""
    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.tools import bench_kernels

    ops.hafner_cell_launches.reset()
    ops.hafner_sequence_launches.reset()
    line = bench_kernels.run("cuda")
    launches = {"hafner_sequence": ops.hafner_sequence_launches.count, "hafner_cell": ops.hafner_cell_launches.count}
    by_variant = dict(ops.hafner_sequence_launches.by_variant)
    print("[bench_kernels] " + json.dumps({**line, "launches": launches, "sequence_launches_by_variant": by_variant}),
          flush=True)
    if launches["hafner_sequence"] == 0 or launches["hafner_cell"] != 0:
        raise AssertionError(f"the kernel bench launched {launches}")
    if by_variant != {line["variant"]: launches["hafner_sequence"]}:
        raise AssertionError(f"the kernel bench ran {by_variant}, its plan names {line['variant']}")
    if line["max_abs_err"] > TOL_SEQUENCE or line["grad_rel_err"] > TOL_GRAD:
        raise AssertionError(f"the kernel bench's kernel path disagrees with its plain path: {line}")
    return launches, line


def _trainer_modules(algo: str):
    """``(agent module, training module, actions, continuous)`` of a bench preset."""
    import importlib

    from sheeprl_tpu_torch.tools import bench_dreamer

    family, _exp, _obs, actions, continuous, *_ = bench_dreamer.PRESETS[algo]
    agent_module, train_module = bench_dreamer.ALGOS[family]
    return importlib.import_module(agent_module), importlib.import_module(train_module), actions, continuous


class _PinnedSamples:
    """Within the block, every straight-through categorical sample a train
    step draws (each imagined discrete action and each posterior and prior
    stochastic state, through the module names the losses call) is recorded
    (the first pass) or, on the second pass (``replay``), replaced by the
    first pass's choice at the same call, its straight-through gradient
    kept. The kernel and the plain-cell paths then take the same discrete
    decisions, so their losses compare; a choice that float rounding flipped
    between them (a near-tie of logits plus Gumbel noise) is counted
    (``flips`` of ``samples``) instead of sending the two steps down
    different trajectories."""

    _TARGETS = (("sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2", "sample_actor_actions"),
                ("sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3", "sample_actor_actions"),
                ("sheeprl_tpu_torch.algos.dreamer_v2.agent", "compute_stochastic_state"),
                ("sheeprl_tpu_torch.algos.dreamer_v3.agent", "compute_stochastic_state"))

    def __init__(self, greedy: bool = False):
        """``greedy``: also the player's greedy discrete actions (the
        evaluation's and the server's, ``dreamer_v3.agent``'s
        ``sample_actor_actions``)."""
        self.choices, self.replay, self.index, self.flips, self.samples = [], False, 0, 0, 0
        self.greedy = greedy

    def _pin(self, out, width: int):
        import torch.nn.functional as F

        shaped = out.reshape(out.shape[:-1] + (-1, width))
        own = shaped.detach().argmax(-1)
        if not self.replay:
            self.choices.append(own)
            return out
        chosen = self.choices[self.index]
        self.index += 1
        flipped = int((chosen != own).sum())
        self.flips += flipped
        self.samples += own.numel()
        if not flipped:
            return out
        return (shaped + (F.one_hot(chosen, width) - F.one_hot(own, width)).to(out.dtype)).reshape(out.shape)

    def __enter__(self):
        import importlib

        self._saved = []
        targets = self._TARGETS + ((("sheeprl_tpu_torch.algos.dreamer_v3.agent", "sample_actor_actions"),)
                                   if self.greedy else ())
        for module_name, attr in targets:
            module = importlib.import_module(module_name)
            original = getattr(module, attr)
            self._saved.append((module, attr, original))
            if attr == "sample_actor_actions":
                def actions(dists, is_continuous, *args, _original=original, **kwargs):
                    out = _original(dists, is_continuous, *args, **kwargs)
                    training = kwargs.get("is_training", args[1] if len(args) > 1 else True)
                    if is_continuous or not (training or self.greedy):
                        return out
                    return [self._pin(o, o.shape[-1]) for o in out]

                setattr(module, attr, actions)
            else:
                def states(logits, discrete, *args, _original=original, **kwargs):
                    return self._pin(_original(logits, discrete, *args, **kwargs), discrete)

                setattr(module, attr, states)
        return self

    def __exit__(self, *exc):
        for module, attr, original in self._saved:
            setattr(module, attr, original)
        return False


def _trainer_width(algo: str) -> int:
    """K = H + X of a bench preset's recurrent cell (recurrent state and its pre-layer's width)."""
    from sheeprl_tpu_torch import configs
    from sheeprl_tpu_torch.tools import bench_dreamer

    _family, exp, *_ = bench_dreamer.PRESETS[algo]
    cfg = configs.dreamer_v2_config(exp)
    rm = cfg.algo.world_model.recurrent_model
    return int(rm.recurrent_state_size) + int(rm.get("dense_units", cfg.algo.dense_units))


def _train_steps_kernel_and_plain(algo: str, seed: int = 0, f64_cell: bool = False):
    """``_train_step_once`` on the kernel path, then on the plain-cell path
    with the kernel path's discrete choices (``_PinnedSamples``), and with
    ``f64_cell`` once more with the cell computed in f64 (``_f64_cell``), the
    same choices pinned. Returns ``((kernel metrics, launches), (plain
    metrics, launches), {"samples", "flips"})``, the f64 cell's metrics under
    ``"f64_cell"`` of the last."""
    pins = _PinnedSamples()
    f64 = None
    with pins:
        kernel = _train_step_once(False, algo, seed)
        pins.replay = True
        plain = _train_step_once(True, algo, seed)
        if pins.index != len(pins.choices):
            raise AssertionError(f"{algo}: the plain-cell step drew {pins.index} samples, the kernel step "
                                 f"{len(pins.choices)}")
        if f64_cell:
            pins.index = 0
            with _cell_in_f64():
                f64, _ = _train_step_once(True, algo, seed)
            if pins.index != len(pins.choices):
                raise AssertionError(f"{algo}: the f64-cell step drew {pins.index} samples, the kernel step "
                                     f"{len(pins.choices)}")
    pinned = {"samples": pins.samples, "flips": pins.flips}
    if f64_cell:
        pinned["f64_cell"] = f64
    return kernel, plain, pinned


@contextlib.contextmanager
def _cell_in_f64():
    """Within the block the plain cell (``kernels.reference.hafner_cell``) is ``_f64_cell``."""
    from sheeprl_tpu_torch.kernels import reference

    plain = reference.hafner_cell
    reference.hafner_cell = _f64_cell
    try:
        yield
    finally:
        reference.hafner_cell = plain


# the step's metrics in reward and return units (normalized advantages, returns, predictions, the entropy term),
# means near 0 at random weights
UNIT_METRICS = ("Loss/policy_loss", "User/LambdaValues", "User/Advantages", "User/PredictedRewards",
                "User/PredictedValues", "User/Entropy")


def _train_step_gaps(kernel_m: dict, plain_m: dict, algo: str):
    """The kernel step's relative gap to the plain-cell step on each metric,
    and each one's limit: losses TOL_TRAIN_LOSS, gradient norms and the other
    metrics TOL_TRAIN_GRAD. At the L and XL widths the 3xTF32 product's error
    against f32 grows with K = H + X, so the metrics' limit grows with K over
    DreamerV3 100k's; and the policy loss and the User/ means (UNIT_METRICS),
    means of O(1) terms that nearly cancel at random weights, are held in
    their units: the gap over max(|plain|, 1). A near-zero mean amplifies any
    rounding of the cell, f32's too (``python3 chip_smoke.py
    --train-gaps``). Returns ``(gaps, limits)``."""
    large = algo in ("dreamer_v3_L", "dreamer_v3_XL")
    K = int(_trainer_width(algo))
    tol_metric = TOL_TRAIN_GRAD * (max(1.0, K / (DV3_H + DV3_X)) if large else 1.0)
    floor = {k: (1.0 if large and k in UNIT_METRICS else 1e-6) for k in kernel_m}
    gaps = {k: abs(kernel_m[k] - plain_m[k]) / max(abs(plain_m[k]), floor[k]) for k in kernel_m}
    limits = {k: TOL_TRAIN_LOSS if k.startswith("Loss/") else tol_metric for k in kernel_m}
    return gaps, limits


def _train_step_once(plain_cell: bool, algo: str = "dreamer_v2", seed: int = 0):
    """One full-width step of the bench preset ``algo`` at fixed weights (``seed``) and fixed noise (SEED +
    ``seed``), at τ=1."""
    import torch

    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.tools import bench_dreamer

    agent, train, actions, continuous = _trainer_modules(algo)
    cfg, state, train_step, data = bench_dreamer.build_trainer("cuda", seed=seed, algo=algo)
    if plain_cell:
        agent.set_cell_impl(state["world_model"], "plain")
    T, B = data["rewards"].shape[:2]
    noise = train.draw_noise(cfg, actions, T, B, torch.Generator(device="cuda").manual_seed(SEED + seed), "cuda",
                             continuous)
    before = ops.hafner_cell_launches.count
    metrics = {k: float(v) for k, v in train_step(state, data, noise=noise, tau=1.0).items()}
    launches = ops.hafner_cell_launches.count - before
    per_step = P2E_STEP_LAUNCHES.get(algo, T + int(cfg.algo.horizon))
    if launches != (0 if plain_cell else per_step):
        raise AssertionError(f"the {'plain-cell' if plain_cell else 'kernel'} train step launched the cell {launches} times")
    del state, data, noise
    torch.cuda.empty_cache()
    return metrics, launches


def _rel(got, want) -> float:
    import torch

    return float((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30))


def _train_steps(fused: bool, algo: str = "dreamer_v2") -> dict:
    """GRAPH_STEPS full-width steps of the bench preset ``algo`` from seed 0 on one batch,
    each step's noise from the trainer's own generator: eager
    (``run_train_burst(..., fused=False)``) or graphed (one-sample bursts:
    the capture's eager warm-up calls, the capture, then replays). The
    target updates as the run's: DV2 a hard copy every 4 steps, DV3 τ =
    0.02 every step after a hard first one."""
    import torch

    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.tools import bench_dreamer
    from sheeprl_tpu_torch.train.burst import run_train_burst, tau_schedule

    if algo.startswith(("dreamer_v3", "p2e_dv3")):
        taus = tau_schedule(GRAPH_STEPS, 0, 1, tau=0.02, first_hard=True)
    else:
        taus = tau_schedule(GRAPH_STEPS, 0, 4, tau=1.0, first_hard=False)
    cfg, state, program, data = bench_dreamer.build_trainer("cuda", seed=0, algo=algo)
    stack = {k: v[None] for k, v in data.items()}
    before = ops.hafner_cell_launches.count
    metrics = [run_train_burst(program, state, stack, taus[i : i + 1], fused=fused) for i in range(GRAPH_STEPS)]
    torch.cuda.synchronize()
    out = {
        "metrics": metrics,
        "params": {f"{name}.{k}": p.detach().cpu() for name, module in _modules_of(state).items()
                   for k, p in module.named_parameters()},
        "launches": ops.hafner_cell_launches.count - before,
        "taus": taus.tolist(),
    }
    if fused:
        step = program.static.step
        out["graph"] = {"eager_calls": step.eager_calls, "replays": step.replays, "captured": step.graph is not None}
    del state, program, data, stack
    torch.cuda.empty_cache()
    return out


def _modules_of(state) -> dict:
    """Every module of a trainer's state by name, each P2E-DV3 exploration
    critic and its target as ``critics_exploration.<name>.{module,target}``."""
    import torch

    out = {name: m for name, m in state.items() if isinstance(m, torch.nn.Module)}
    for k, pair in state.get("critics_exploration", {}).items():
        out.update({f"critics_exploration.{k}.{part}": m for part, m in pair.items()})
    return out


def _steps_diff(got: dict, want: dict) -> dict:
    import torch

    return {
        "metric_max_rel_err": max(abs(g[k] - e[k]) / max(abs(e[k]), 1e-30)
                                  for g, e in zip(got["metrics"], want["metrics"]) for k in e),
        "param_max_rel_err": max(_rel(got["params"][k], want["params"][k]) for k in want["params"]),
        "bit_for_bit": all(g == e for g, e in zip(got["metrics"], want["metrics"]))
        and all(torch.equal(got["params"][k], want["params"][k]) for k in want["params"]),
    }


def graphed_against_eager() -> dict:
    """GRAPH_STEPS full-width steps from one seed, eager and graphed, every
    step's losses and gradient norms and the final parameters compared
    relative to each tensor's largest magnitude, and the cell's launches (65
    a step on both). With cuDNN's default algorithms two eager runs are not
    equal (the convolutions' weight gradients accumulate with atomics), so
    graphed against eager is held there within GRAPHED_DEFAULT_SPREADS
    times the spread between two eager runs (at least TOL_GRAPHED); the limit
    TOL_GRAPHED is held with ``cudnn.deterministic``."""
    import torch

    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    prev = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = False
        eager_a, eager_b, graphed_default = _train_steps(False), _train_steps(False), _train_steps(True)
        torch.backends.cudnn.deterministic = True
        eager, graphed = _train_steps(False), _train_steps(True)
    finally:
        torch.backends.cudnn.deterministic = prev
    held = _steps_diff(graphed, eager)
    spread, default = _steps_diff(eager_b, eager_a), _steps_diff(graphed_default, eager_a)
    default_tol = {k: max(GRAPHED_DEFAULT_SPREADS * spread[k], TOL_GRAPHED)
                   for k in ("metric_max_rel_err", "param_max_rel_err")}
    line = {"steps": GRAPH_STEPS, "taus": eager["taus"], "tol": TOL_GRAPHED,
            "cudnn_deterministic": held,
            "cudnn_default": {"eager_vs_eager": spread, "graphed_vs_eager": default, "tol": default_tol},
            "launches": {"eager": eager["launches"], "graphed": graphed["launches"]}, "graph": graphed["graph"],
            "last_losses": {"eager": eager["metrics"][-1], "graphed": graphed["metrics"][-1]}}
    print("[train] graphed against eager: " + json.dumps(line), flush=True)
    if held["metric_max_rel_err"] > TOL_GRAPHED or held["param_max_rel_err"] > TOL_GRAPHED:
        raise AssertionError(f"graphed and eager steps disagree: {held} > {TOL_GRAPHED}")
    if any(default[k] > tol for k, tol in default_tol.items()):
        raise AssertionError(f"with cuDNN's defaults graphed and eager steps disagree: {default} > {default_tol}")
    for run in (eager_a, eager_b, graphed_default, eager, graphed):
        if run["launches"] != CELL_LAUNCHES_PER_STEP * GRAPH_STEPS:
            raise AssertionError(f"the cell launched {run['launches']} times in {GRAPH_STEPS} steps")
    for run in (graphed_default, graphed):
        if run["graph"] != {"eager_calls": WARMUP_CALLS, "replays": GRAPH_STEPS - WARMUP_CALLS, "captured": True}:
            raise AssertionError(f"the graphed steps ran as {run['graph']}")
    return {"metric_max_rel_err": held["metric_max_rel_err"], "param_max_rel_err": held["param_max_rel_err"],
            "bit_for_bit": held["bit_for_bit"]}


def phase_train(card: str):
    import math

    import torch

    from sheeprl_tpu_torch.tools import bench_dreamer

    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        (kernel_m, kernel_n), (plain_m, plain_n), pinned = _train_steps_kernel_and_plain("dreamer_v2")
        graph_line = graphed_against_eager()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    rel = {k: abs(kernel_m[k] - plain_m[k]) / max(abs(plain_m[k]), 1e-6) for k in kernel_m}
    bad = [k for k, r in rel.items() if r > (TOL_TRAIN_GRAD if k.startswith("Grads/") else TOL_TRAIN_LOSS)]
    bad += [k for k, v in kernel_m.items() if not math.isfinite(v)]
    print("[train] kernel vs plain cell, one step: " + json.dumps(
        {"kernel": kernel_m, "plain": plain_m, "rel_diff": rel, "tol_loss": TOL_TRAIN_LOSS, "tol_grad": TOL_TRAIN_GRAD,
         "cell_launches": {"kernel": kernel_n, "plain": plain_n}, "pinned_samples": pinned}
    ), flush=True)
    if bad:
        raise AssertionError(f"kernel and plain-cell train steps disagree on {bad}")

    # eager and graphed in the same call, on fresh trainers of the same seed; the main path runs graphed
    result = bench_dreamer.compare(steps=TRAIN_STEPS, device="cuda", profile=True)
    result["card"] = card
    print("[train] " + json.dumps(result), flush=True)
    for mode in ("eager", "graphed"):
        line = result[mode]
        if not all(math.isfinite(v) for v in line["losses"].values()):
            raise AssertionError(f"a {mode} loss is not finite: {line['losses']}")
        if line["hafner_cell_launches"] != CELL_LAUNCHES_PER_STEP * TRAIN_STEPS:
            raise AssertionError(f"the {mode} cell launched {line['hafner_cell_launches']} times in {TRAIN_STEPS} steps")
        if line["hafner_sequence_launches"] != 0:
            raise AssertionError(f"the sequence kernel ran on the {mode} train path")
    graphed = result["graphed"]
    launches = {"hafner_cell": graphed["hafner_cell_launches"], "hafner_sequence": graphed["hafner_sequence_launches"]}
    return launches, max(rel.values()), graph_line


def imagination_split(algo: str = "dreamer_v3_walker") -> dict:
    """Device time of the actor loss at full width, fixed weights and noise:
    its forward (the horizon's imagination with autograd, the critic and the
    heads over the trajectories, the λ-returns) and its forward and backward
    into the actor (the backward runs through every imagined cell step's
    VJP), each captured and replayed (``device_ms``); the backward is their
    difference."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import _no_param_grads, _prepare
    from sheeprl_tpu_torch.tools import bench_dreamer

    _agent, train, actions, continuous = _trainer_modules(algo)
    cfg, state, _program, data = bench_dreamer.build_trainer("cuda", seed=0, algo=algo)
    _prepare(state)
    losses = train.build_losses(cfg, actions, continuous)
    T, B = data["rewards"].shape[:2]
    noise = train.draw_noise(cfg, actions, T, B, torch.Generator(device="cuda").manual_seed(SEED), "cuda", continuous)
    wm, actor, critic = state["world_model"], state["actor"], state["critic"]
    with torch.no_grad():
        _loss, _metrics, posteriors, recurrents = losses.world_model_loss(wm, data, noise["posterior"])
    args = (wm, actor, critic, state["moments"], posteriors, recurrents, (1.0 - data["dones"]).reshape(-1, 1), noise)

    def forward():
        with _no_param_grads(wm, critic):
            losses.actor_loss(*args)

    fwd_ms = device_ms(forward, calls=2, n=10)
    both_ms = device_ms(lambda: losses.actor_loss_backward(*args), calls=2, n=10)
    del state, data, noise, args
    torch.cuda.empty_cache()
    return {"actor_loss_forward_ms": fwd_ms, "actor_loss_forward_backward_ms": both_ms,
            "actor_loss_backward_ms": both_ms - fwd_ms}


def phase_train_dv3(card: str, algo: str = "dreamer_v3"):
    """A DreamerV3 trainer at full width (B=16, T=64, horizon 15): the 100k
    MsPacman preset (``dreamer_v3``) or the DMC walker preset
    (``dreamer_v3_walker``: rgb and state, 6 continuous actions, the actor's
    gradient through the imagination). One step at fixed weights and noise
    on the kernel path and on the plain-cell path (TF32 off: losses within
    TOL_TRAIN_LOSS, gradient norms within TOL_TRAIN_GRAD, relative);
    GRAPH_STEPS steps from one seed eager and graphed with
    ``cudnn.deterministic`` (losses, gradient norms and parameters bit for
    bit); for the walker the actor loss's forward and backward apart
    (``imagination_split``); then DV3_TRAIN_STEPS timed steps eager and as
    many graphed, each with a profiled window (device busy time, idle share,
    top operations) and the peak memory, 79 cell launches a step."""
    import math

    import torch

    from sheeprl_tpu_torch.tools import bench_dreamer
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    tag = {"dreamer_v3": "train_dv3", "dreamer_v3_walker": "train_walker"}.get(algo, f"train_{algo.replace('dreamer_v', 'dv')}")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        (kernel_m, kernel_n), (plain_m, plain_n), pinned = _train_steps_kernel_and_plain(algo)
        torch.backends.cudnn.deterministic = True
        eager, graphed = _train_steps(False, algo), _train_steps(True, algo)
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = prev
    rel, limits = _train_step_gaps(kernel_m, plain_m, algo)
    bad = [k for k, r in rel.items() if r > limits[k]]
    bad += [k for k, v in kernel_m.items() if not math.isfinite(v)]
    held = _steps_diff(graphed, eager)
    line = {"kernel_vs_plain": {"kernel": kernel_m, "plain": plain_m, "rel_diff": rel, "limits": limits,
                                "cell_K": int(_trainer_width(algo)),
                                "cell_launches": {"kernel": kernel_n, "plain": plain_n}, "pinned_samples": pinned},
            "graphed_vs_eager": {"steps": GRAPH_STEPS, "taus": eager["taus"],
                                 "cudnn_deterministic": held, "graph": graphed["graph"],
                                 "launches": {"eager": eager["launches"], "graphed": graphed["launches"]}}}
    print(f"[{tag}] " + json.dumps(line), flush=True)
    if bad:
        raise AssertionError(f"{tag}: kernel and plain-cell train steps disagree on {bad}")
    if not held["bit_for_bit"]:
        raise AssertionError(f"{tag}: graphed and eager steps are not bit for bit with cudnn.deterministic: {held}")
    for run in (eager, graphed):
        if run["launches"] != DV3_CELL_LAUNCHES_PER_STEP * GRAPH_STEPS:
            raise AssertionError(f"{tag}: the cell launched {run['launches']} times in {GRAPH_STEPS} steps")
    if graphed["graph"] != {"eager_calls": WARMUP_CALLS, "replays": GRAPH_STEPS - WARMUP_CALLS, "captured": True}:
        raise AssertionError(f"{tag}: the graphed steps ran as {graphed['graph']}")
    split = imagination_split(algo) if algo == "dreamer_v3_walker" else None

    result = bench_dreamer.compare(steps=DV3_TRAIN_STEPS, device="cuda", profile=True, algo=algo)
    result["card"] = card
    if split is not None:
        result["actor_loss_split"] = split
    print(f"[{tag}] " + json.dumps(result), flush=True)
    for mode in ("eager", "graphed"):
        side = result[mode]
        if not all(math.isfinite(v) for v in side["losses"].values()):
            raise AssertionError(f"{tag}: a {mode} loss is not finite: {side['losses']}")
        if side["hafner_cell_launches"] != DV3_CELL_LAUNCHES_PER_STEP * DV3_TRAIN_STEPS or side["hafner_sequence_launches"]:
            raise AssertionError(f"{tag}: the {mode} steps launched the cell {side['hafner_cell_launches']} times "
                                 f"and the sequence {side['hafner_sequence_launches']} times")
        if side["hafner_cell_launches_by_operand_dtype"] != {"f32": side["hafner_cell_launches"]}:
            raise AssertionError(f"{tag}: the {mode} cell launches by operand dtype "
                                 f"{side['hafner_cell_launches_by_operand_dtype']}")
    launches = {"hafner_cell": result["graphed"]["hafner_cell_launches"],
                "hafner_sequence": result["graphed"]["hafner_sequence_launches"]}
    return launches, max(rel.values()), {k: held[k] for k in ("metric_max_rel_err", "param_max_rel_err", "bit_for_bit")}


def phase_train_dv2_continuous(card: str):
    """DreamerV2 at ``exp=dreamer_v2``'s width (B=16, T=50, horizon 15) on a
    2-wide Box of actions (the continuous dummy env's): GRAPH_STEPS steps
    from one seed eager and graphed with ``cudnn.deterministic``, held to
    TOL_GRAPHED, 65 cell launches a step. The counts are zeroed before the
    graphed steps and read after them."""
    import torch

    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    algo = "dreamer_v2_continuous"
    prev = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = True
        eager = _train_steps(False, algo)
        ops.hafner_cell_launches.reset()
        ops.hafner_sequence_launches.reset()
        graphed = _train_steps(True, algo)
        launches = {"hafner_cell": ops.hafner_cell_launches.count,
                    "hafner_sequence": ops.hafner_sequence_launches.count}
    finally:
        torch.backends.cudnn.deterministic = prev
    held = _steps_diff(graphed, eager)
    line = {"steps": GRAPH_STEPS, "taus": eager["taus"], "tol": TOL_GRAPHED, "cudnn_deterministic": held,
            "graph": graphed["graph"], "launches": {"eager": eager["launches"], "graphed": graphed["launches"]},
            "last_losses": {"eager": eager["metrics"][-1], "graphed": graphed["metrics"][-1]}, "card": card}
    print("[train_dv2_continuous] " + json.dumps(line), flush=True)
    if held["metric_max_rel_err"] > TOL_GRAPHED or held["param_max_rel_err"] > TOL_GRAPHED:
        raise AssertionError(f"graphed and eager continuous DV2 steps disagree: {held} > {TOL_GRAPHED}")
    for run in (eager, graphed):
        if run["launches"] != CELL_LAUNCHES_PER_STEP * GRAPH_STEPS:
            raise AssertionError(f"the continuous DV2 cell launched {run['launches']} times in {GRAPH_STEPS} steps")
    if graphed["graph"] != {"eager_calls": WARMUP_CALLS, "replays": GRAPH_STEPS - WARMUP_CALLS, "captured": True}:
        raise AssertionError(f"the graphed continuous DV2 steps ran as {graphed['graph']}")
    return launches, held


def phase_train_p2e(card: str, algo: str):
    """A Plan2Explore exploration trainer at its preset's full width
    (bench_dreamer's ``p2e_dv3``: B=16 x T=64, an 8-member ensemble, two
    exploration critics; ``p2e_dv3_continuous``: the same on the walker's
    observations and 6 continuous actions, both actors' gradients through
    their imaginations; ``p2e_dv2``: B=16 x T=50, 10 members). One step at
    fixed weights and noise on the kernel path and on the plain-cell path
    (TF32 off: losses within TOL_TRAIN_LOSS, the six updates' gradient norms
    and the other metrics within TOL_TRAIN_GRAD, relative); GRAPH_STEPS
    steps from one seed eager and graphed with ``cudnn.deterministic``
    (losses, gradient norms and every module's parameters within
    TOL_GRAPHED); then P2E_TRAIN_STEPS timed steps eager and as many graphed,
    each with a profiled window and the peak memory; P2E_STEP_LAUNCHES cell
    launches a step. The counts are read on the graphed timed steps."""
    import math

    import torch

    from sheeprl_tpu_torch.tools import bench_dreamer
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    tag = f"train_{algo}"
    per_step = P2E_STEP_LAUNCHES[algo]
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        (kernel_m, kernel_n), (plain_m, plain_n), pinned = _train_steps_kernel_and_plain(algo)
        torch.backends.cudnn.deterministic = True
        eager, graphed = _train_steps(False, algo), _train_steps(True, algo)
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = prev
    rel = {k: abs(kernel_m[k] - plain_m[k]) / max(abs(plain_m[k]), 1e-6) for k in kernel_m}
    bf16 = algo.endswith("_bf16")
    tol_loss, tol_grad = (TOL_TRAIN_BF16, TOL_TRAIN_BF16) if bf16 else (TOL_TRAIN_LOSS, TOL_TRAIN_GRAD)
    bad = [k for k, r in rel.items() if r > (tol_loss if k.startswith("Loss/") else tol_grad)]
    bad += [k for k, v in kernel_m.items() if not math.isfinite(v)]
    held = _steps_diff(graphed, eager)
    line = {"kernel_vs_plain": {"kernel": kernel_m, "plain": plain_m, "rel_diff": rel, "tol_loss": tol_loss,
                                "tol_grad": tol_grad, "cell_launches": {"kernel": kernel_n, "plain": plain_n},
                                "pinned_samples": pinned},
            "graphed_vs_eager": {"steps": GRAPH_STEPS, "taus": eager["taus"], "tol": TOL_GRAPHED,
                                 "cudnn_deterministic": held, "graph": graphed["graph"],
                                 "launches": {"eager": eager["launches"], "graphed": graphed["launches"]}},
            "card": card}
    print(f"[{tag}] " + json.dumps(line), flush=True)
    if bad:
        raise AssertionError(f"{tag}: kernel and plain-cell train steps disagree on {bad}")
    if held["metric_max_rel_err"] > TOL_GRAPHED or held["param_max_rel_err"] > TOL_GRAPHED:
        raise AssertionError(f"{tag}: graphed and eager steps disagree: {held} > {TOL_GRAPHED}")
    for run in (eager, graphed):
        if run["launches"] != per_step * GRAPH_STEPS:
            raise AssertionError(f"{tag}: the cell launched {run['launches']} times in {GRAPH_STEPS} steps")
    if graphed["graph"] != {"eager_calls": WARMUP_CALLS, "replays": GRAPH_STEPS - WARMUP_CALLS, "captured": True}:
        raise AssertionError(f"{tag}: the graphed steps ran as {graphed['graph']}")

    result = bench_dreamer.compare(steps=P2E_TRAIN_STEPS, device="cuda", profile=True, algo=algo)
    result["card"] = card
    print(f"[{tag}] " + json.dumps(result), flush=True)
    for mode in ("eager", "graphed"):
        side = result[mode]
        if not all(math.isfinite(v) for v in side["losses"].values()):
            raise AssertionError(f"{tag}: a {mode} loss is not finite: {side['losses']}")
        if side["hafner_cell_launches"] != per_step * P2E_TRAIN_STEPS or side["hafner_sequence_launches"]:
            raise AssertionError(f"{tag}: the {mode} steps launched the cell {side['hafner_cell_launches']} times "
                                 f"and the sequence {side['hafner_sequence_launches']} times")
        if side["hafner_cell_launches_by_operand_dtype"] != {"bf16" if bf16 else "f32": side["hafner_cell_launches"]}:
            raise AssertionError(f"{tag}: the {mode} cell launches by operand dtype "
                                 f"{side['hafner_cell_launches_by_operand_dtype']}")
    launches = {"hafner_cell": result["graphed"]["hafner_cell_launches"],
                "hafner_sequence": result["graphed"]["hafner_sequence_launches"]}
    return launches, max(rel.values()), {k: held[k] for k in ("metric_max_rel_err", "param_max_rel_err", "bit_for_bit")}


def _card_against_cpu_step(algo: str) -> dict:
    """One full-width step of the bench preset ``algo`` at DV1_CPU_OVERRIDES
    (the batch cut, the updates that precede later losses at learning rate
    0) on the card and on the CPU, from the same seeded weights, batch and
    noise (drawn on the CPU, copied to the card), TF32 off on the card.
    Returns each side's metrics, each metric's relative gap and its limit,
    and the card step's cell launches (0: no kernel on this path)."""
    import torch

    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.tools import bench_dreamer

    _agent, train, actions, continuous = _trainer_modules(algo)
    overrides = dict(DV1_CPU_OVERRIDES)
    if algo.startswith("p2e_"):
        overrides["algo.ensembles.optimizer.lr"] = 0.0
    metrics, noise = {}, None
    for device in ("cpu", "cuda"):
        cfg, state, program, data = bench_dreamer.build_trainer(device, seed=0, algo=algo, **overrides)
        T, B = data["rewards"].shape[:2]
        if noise is None:
            noise = train.draw_noise(cfg, actions, T, B, torch.Generator().manual_seed(SEED), "cpu", continuous)
        moved = {k: [t.to(device) for t in v] if isinstance(v, list) else v.to(device) for k, v in noise.items()}
        before = ops.hafner_cell_launches.count
        metrics[device] = {k: float(v) for k, v in program(state, data, noise=moved).items()}
        launches = ops.hafner_cell_launches.count - before
        del state, program, data
    torch.cuda.empty_cache()
    card, cpu = metrics["cuda"], metrics["cpu"]
    gaps = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-6) for k in cpu}
    limits = {k: TOL_TRAIN_LOSS if k.startswith("Loss/") else TOL_TRAIN_GRAD for k in cpu}
    return {"card": card, "cpu": cpu, "rel_diff": gaps, "limits": limits, "overrides": overrides,
            "cell_launches": launches}


def phase_train_dv1(card: str, algo: str = "dreamer_v1"):
    """DreamerV1's trainer (``dreamer_v1``: B=50 x T=50, horizon 15, the
    discrete dummy env's 2 actions) or P2E-DV1's exploration step
    (``p2e_dv1``) at the preset's full width. Its recurrent core is PyTorch
    operations, so the checks are of another kind than the kernel phases':
    the card's step against the port's own CPU step (``_card_against_cpu_step``,
    which the CPU tests hold against JAX); GRAPH_STEPS steps from one seed
    eager and graphed with ``cudnn.deterministic`` (losses, gradient norms
    and every module's parameters within TOL_GRAPHED), and for DreamerV1 the
    same on a 2-wide Box of actions (``dreamer_v1_continuous``: the actor's
    gradient through the reparameterized samples and the imagined dynamics);
    then DV1_TRAIN_STEPS timed steps eager and as many graphed, each with a
    profiled window (device busy time, idle share, top operations) and the
    peak memory. No path launches the cell kernel: its gates are the
    LayerNorm-GRU's, not flax's GRU's. The counts are read on the graphed
    timed steps."""
    import math

    import torch

    from sheeprl_tpu_torch.tools import bench_dreamer
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    tag = f"train_{algo.replace('dreamer_v', 'dv')}"
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        against_cpu = _card_against_cpu_step(algo)
        torch.backends.cudnn.deterministic = True
        graph_algos = (algo, "dreamer_v1_continuous") if algo == "dreamer_v1" else (algo,)
        graphed_lines, steps = {}, []
        for name in graph_algos:
            eager, graphed = _train_steps(False, name), _train_steps(True, name)
            steps += [eager, graphed]
            graphed_lines[name] = {**_steps_diff(graphed, eager), "graph": graphed["graph"],
                                   "launches": {"eager": eager["launches"], "graphed": graphed["launches"]}}
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = prev
    line = {"card_vs_cpu": against_cpu, "graphed_vs_eager": graphed_lines, "steps": GRAPH_STEPS, "tol": TOL_GRAPHED,
            "card": card}
    print(f"[{tag}] " + json.dumps(line), flush=True)
    bad = [k for k, r in against_cpu["rel_diff"].items() if not r <= against_cpu["limits"][k]]
    bad += [k for k, v in against_cpu["card"].items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{tag}: the card's step and the CPU step disagree on {bad}")
    for name, held in graphed_lines.items():
        if held["metric_max_rel_err"] > TOL_GRAPHED or held["param_max_rel_err"] > TOL_GRAPHED:
            raise AssertionError(f"{tag}: graphed and eager {name} steps disagree: {held} > {TOL_GRAPHED}")
        if held["graph"] != {"eager_calls": WARMUP_CALLS, "replays": GRAPH_STEPS - WARMUP_CALLS, "captured": True}:
            raise AssertionError(f"{tag}: the graphed {name} steps ran as {held['graph']}")
    if against_cpu["cell_launches"] or any(run["launches"] for run in steps):
        raise AssertionError(f"{tag}: a DreamerV1 step launched hafner_cell")

    result = bench_dreamer.compare(steps=DV1_TRAIN_STEPS, device="cuda", profile=True, algo=algo)
    result["card"] = card
    print(f"[{tag}] " + json.dumps(result), flush=True)
    for mode in ("eager", "graphed"):
        side = result[mode]
        if not all(math.isfinite(v) for v in side["losses"].values()):
            raise AssertionError(f"{tag}: a {mode} loss is not finite: {side['losses']}")
        if side["hafner_cell_launches"] or side["hafner_sequence_launches"]:
            raise AssertionError(f"{tag}: the {mode} steps launched the cell {side['hafner_cell_launches']} times "
                                 f"and the sequence {side['hafner_sequence_launches']} times")
    launches = {"hafner_cell": result["graphed"]["hafner_cell_launches"],
                "hafner_sequence": result["graphed"]["hafner_sequence_launches"]}
    return launches, {"card_vs_cpu_max_rel_diff": max(against_cpu["rel_diff"].values()),
                      "graphed_vs_eager": {k: {n: v[n] for n in ("metric_max_rel_err", "param_max_rel_err",
                                                                   "bit_for_bit")} for k, v in graphed_lines.items()}}


def _run_once(root: str, name: str, args=RUN_ARGS):
    """One training run through the CLI; returns (result, wall seconds)."""
    import torch

    from sheeprl_tpu_torch import cli

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = cli.run(list(args) + [f"root_dir={root}", f"run_name={name}"])
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def trace_summary(prof, names) -> tuple:
    """``(device busy µs, {name: count})`` of a ``torch.profiler`` window:
    every device event's time (a user-annotated range spans kernels counted
    on their own), and the device events whose name holds each of
    ``names``. Read from the profiler's raw events: building its function
    events and averages takes minutes on a run of 10^5-10^6 kernels."""
    from torch.autograd import DeviceType

    from sheeprl_tpu_torch.tools.profile_serve import device_us

    counts = dict.fromkeys(names, 0)
    busy = 0.0
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:  # a PyTorch without the raw events: the averages
        events = None
    if events is None:
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                busy += device_us(e)
                for n in names:
                    counts[n] += e.count if n in e.key else 0
        return busy, counts
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        busy += e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else e.duration_us()
        name = e.name()
        for n in names:
            counts[n] += n in name
    return busy, counts


def _check_events(result, spec) -> dict:
    """The run's event file, read back with the port's reader: the preset's
    tags at the log boundaries (``spec["log_steps"]``), every value finite."""
    import math

    from sheeprl_tpu_torch.utils.tb_events import read_events

    events = read_events(result["event_file"])
    if events[0].get("file_version") != "brain.Event:2":
        raise AssertionError("the event file does not start with its file_version event")
    by_step = {}
    for e in events[1:]:
        for v in e.get("values", []):
            by_step.setdefault(e["step"], {})[v["tag"]] = v.get("simple_value")
    texts = by_step.pop(0, {})
    if "hparams/text_summary" not in texts or "Test/cumulative_reward" not in texts:
        raise AssertionError(f"the event file's step 0 holds {sorted(texts)}")
    if tuple(sorted(by_step)) != spec["log_steps"]:
        raise AssertionError(f"the run logged at policy steps {sorted(by_step)}, expected {spec['log_steps']}")
    learning_starts = spec["learning_starts"]
    for step, tags in by_step.items():
        want = set(RUN_TAGS_ALWAYS) | (set(RUN_TAGS_TRAINING) if step > learning_starts else set())
        if not want <= set(tags):
            raise AssertionError(f"policy step {step} lacks the tags {sorted(want - set(tags))}")
        bad = [t for t, v in tags.items() if v is None or not math.isfinite(v)]
        if bad:
            raise AssertionError(f"policy step {step}: tags {bad} are not finite")
    episodes = [step for step, tags in by_step.items() if "Rewards/rew_avg" in tags and "Game/ep_len_avg" in tags]
    if not episodes:
        raise AssertionError("no log boundary holds the episodes' Rewards/rew_avg and Game/ep_len_avg")
    return {"events": len(events), "log_steps": sorted(by_step), "tags_at_last_log": len(by_step[spec["log_steps"][-1]]),
            "episode_metrics_at": episodes, "ep_len_avg": [by_step[s]["Game/ep_len_avg"] for s in episodes]}


def _check_episode_buffer(ckpt) -> dict:
    """The checkpoint's episode buffer, every crc32 verified, restored into
    a fresh buffer whose ``state_dict`` equals the one read back."""
    import numpy as np

    from sheeprl_tpu_torch.ckpt import read_checkpoint
    from sheeprl_tpu_torch.data.buffers import EpisodeBuffer

    opts = dict(a.split("=", 1) for a in RUN_ARGS)
    n_envs = int(opts["env.num_envs"])
    rb_state = read_checkpoint(ckpt, verify=True)["rb"]
    fresh = EpisodeBuffer(int(opts["buffer.size"]) // n_envs, 50, n_envs=n_envs, obs_keys=("rgb",), prioritize_ends=True)
    fresh.load_state_dict(rb_state)
    restored = fresh.state_dict()
    same = len(restored["buffer"]) == len(rb_state["buffer"]) and all(
        np.array_equal(ep[k], want[k]) for ep, want in zip(restored["buffer"], rb_state["buffer"]) for k in want
    ) and all(
        len(a) == len(b) and all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in y)
        for a, b in zip(restored["open_episodes"], rb_state["open_episodes"])
    )
    if not same or len(fresh) == 0:
        raise AssertionError(f"the checkpoint's episode buffer ({len(fresh)} episodes) did not restore equal")
    return {"episodes": len(fresh), "steps": int(sum(len(ep["dones"]) for ep in rb_state["buffer"])),
            "open_steps": [int(sum(len(c["dones"]) for c in env)) for env in rb_state["open_episodes"]],
            "restored_state_dict_equal": True}


def _check_sequential_buffer(ckpt, args=RUN_DV3_ARGS, obs_keys=("rgb",)) -> dict:
    """The checkpoint's sequential buffer, every crc32 verified, restored
    into a fresh buffer whose ``state_dict`` equals the one read back."""
    import numpy as np

    from sheeprl_tpu_torch.ckpt import read_checkpoint
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer

    del args  # the envs and each one's size come from the checkpoint
    rb_state = read_checkpoint(ckpt, verify=True)["rb"]
    per_env = next(iter(rb_state["buffers"][0]["buffer"].values())).shape[0]
    fresh = EnvIndependentReplayBuffer(per_env, n_envs=len(rb_state["buffers"]), obs_keys=tuple(obs_keys),
                                       buffer_cls=SequentialReplayBuffer)
    fresh.load_state_dict(rb_state)
    restored = fresh.state_dict()["buffers"]
    same = len(restored) == len(rb_state["buffers"]) and all(
        a["pos"] == b["pos"] and a["full"] == b["full"] and a["buffer"].keys() == b["buffer"].keys()
        and all(np.array_equal(a["buffer"][k], b["buffer"][k]) for k in b["buffer"])
        for a, b in zip(restored, rb_state["buffers"])
    )
    steps = int(rb_state["buffers"][0]["pos"])
    if not same or steps == 0:
        raise AssertionError(f"the checkpoint's sequential buffer ({steps} steps) did not restore equal")
    return {"steps": steps, "envs": len(rb_state["buffers"]), "full": bool(rb_state["buffers"][0]["full"]),
            "keys": sorted(rb_state["buffers"][0]["buffer"]), "restored_state_dict_equal": True}


def _f32_parameters(ckpt) -> dict:
    """Every floating array of the checkpoint's agent (the modules'
    parameters, the optimizers' state) is f32, at any precision: bf16-mixed
    computes in bf16 and keeps its parameters in f32. Returns the counts."""
    import numpy as np

    from sheeprl_tpu_torch.ckpt import read_checkpoint

    dtypes = {}

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, np.ndarray) and np.issubdtype(node.dtype, np.floating):
            dtypes[str(node.dtype)] = dtypes.get(str(node.dtype), 0) + 1

    walk(read_checkpoint(ckpt, with_rb=False)["agent"])
    if set(dtypes) != {"float32"}:
        raise AssertionError(f"the checkpoint's agent holds floating arrays of {dtypes}")
    return {"float32_arrays": dtypes["float32"]}


def _greedy_against_plain(ckpt) -> dict:
    """The walker checkpoint's weights acting greedily (the best of
    GREEDY_SAMPLES samples by ``log_prob``) for RUN_CLIENTS rows over
    WALKER_GREEDY_STEPS chained steps of seeded observations: the kernel
    path against a plain-cell replay at the same injected noise (the
    posterior's Gumbels and the samples' uniforms, drawn once a step)."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import GREEDY_SAMPLES, build_agent, build_player_fns, set_cell_impl
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import normalize_obs
    from sheeprl_tpu_torch.ckpt import read_checkpoint
    from sheeprl_tpu_torch.cli import load_run_config
    from sheeprl_tpu_torch.distributions import gumbel_noise, truncated_uniform_noise

    cfg, _log_dir = load_run_config(ckpt)
    agent = read_checkpoint(ckpt, with_rb=False)["agent"]
    players = []
    for impl in ("auto", "plain"):
        wm, actor, _critic, _target = build_agent(cfg, (WALKER_ACTIONS,), True, WALKER_OBS, device="cuda",
                                                  training=True)
        wm.load_state_dict({k: torch.as_tensor(v) for k, v in agent["world_model"].items()})
        actor.load_state_dict({k: torch.as_tensor(v) for k, v in agent["actor"].items()})
        set_cell_impl(wm, impl)
        players.append(build_player_fns(wm, actor, cfg, (WALKER_ACTIONS,), True))
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    states = [p["init_states"](RUN_CLIENTS) for p in players]
    action_err = state_err = 0.0
    for _ in range(WALKER_GREEDY_STEPS):
        obs = {"rgb": rng.randint(0, 256, (RUN_CLIENTS,) + WALKER_OBS["rgb"]).astype(np.uint8),
               "state": rng.randn(RUN_CLIENTS, *WALKER_OBS["state"]).astype(np.float32)}
        norm = normalize_obs(obs, ["rgb"], torch.device("cuda"))
        gumbel = gumbel_noise((RUN_CLIENTS, S, D), gen, "cuda")
        uniforms = truncated_uniform_noise((GREEDY_SAMPLES, RUN_CLIENTS, WALKER_ACTIONS), gen, "cuda")
        actions = []
        for i, player in enumerate(players):
            out, states[i] = player["greedy_action"](states[i], norm, gumbel=gumbel, action_noise=[uniforms])
            actions.append(out[0])
        if not torch.isfinite(actions[0]).all() or actions[0].abs().max().item() > 1.0:
            raise AssertionError("a greedy walker action is not finite or outside [-1, 1]")
        action_err = max(action_err, (actions[0] - actions[1]).abs().max().item())
        state_err = max(state_err, (states[0]["recurrent"] - states[1]["recurrent"]).abs().max().item())
    if action_err > TOL_CONTINUOUS_ACTION or state_err > TOL_STATE:
        raise AssertionError(f"greedy walker actions: kernel against plain cell differ by {action_err} "
                             f"(tol {TOL_CONTINUOUS_ACTION}), states by {state_err} (tol {TOL_STATE})")
    return {"rows": RUN_CLIENTS, "steps": WALKER_GREEDY_STEPS, "samples": GREEDY_SAMPLES,
            "plain_replay_action_max_abs_err": action_err, "plain_replay_state_max_abs_err": state_err}


def _serve_frames(obs_shapes, rng) -> dict:
    """RUN_REQUESTS x RUN_CLIENTS seeded observations: uint8 frames, Gaussian vectors."""
    import numpy as np

    return {k: rng.randint(0, 256, (RUN_REQUESTS, RUN_CLIENTS) + shape).astype(np.uint8) if len(shape) == 3
            else rng.randn(RUN_REQUESTS, RUN_CLIENTS, *shape).astype(np.float32) for k, shape in obs_shapes.items()}


#: the training runs through the CLI: the DV2 MsPacman preset's, the DV3 100k preset's and the DV3 walker preset's
RUN_SPECS = {
    "run": dict(args=RUN_ARGS, counts=(RUN_UPDATES, RUN_PLAYER_STEPS, RUN_GRADIENT_STEPS, RUN_TEST_STEPS),
                per_step=CELL_LAUNCHES_PER_STEP, log_steps=RUN_LOG_STEPS, learning_starts=544,
                buffer=_check_episode_buffer, obs=OBS, continuous=False),
    "run_dv3": dict(args=RUN_DV3_ARGS,
                    counts=(RUN_DV3_UPDATES, RUN_DV3_PLAYER_STEPS, RUN_DV3_GRADIENT_STEPS, RUN_DV3_TEST_STEPS),
                    per_step=DV3_CELL_LAUNCHES_PER_STEP, log_steps=RUN_DV3_LOG_STEPS, learning_starts=1024,
                    buffer=_check_sequential_buffer, obs=OBS, continuous=False),
    "run_walker": dict(args=RUN_WALKER_ARGS,
                       counts=(RUN_WALKER_UPDATES, RUN_WALKER_PLAYER_STEPS, RUN_WALKER_GRADIENT_STEPS,
                               RUN_WALKER_TEST_STEPS),
                       per_step=DV3_CELL_LAUNCHES_PER_STEP, log_steps=RUN_WALKER_LOG_STEPS, learning_starts=1024,
                       buffer=lambda ckpt: _check_sequential_buffer(ckpt, RUN_WALKER_ARGS, tuple(WALKER_OBS)),
                       obs=WALKER_OBS, continuous=True),
    # (updates, player steps, gradient steps, test steps) read off the loop's counters, as for run_dv3; the test
    # episode is one stand-in episode
    "run_dv3_L": dict(args=RUN_L_ARGS, counts=(136, 8, 9, STAND_IN_EPISODE), per_step=DV3_CELL_LAUNCHES_PER_STEP,
                      log_steps=(256, 512, 768, 1024, 1088), learning_starts=1024,
                      buffer=lambda ckpt: _check_sequential_buffer(ckpt, RUN_L_ARGS, tuple(DOAPP_L_OBS)),
                      obs=DOAPP_L_OBS, continuous=False, actions=DOAPP_ACTIONS),
    "run_dv3_XL": dict(args=RUN_XL_ARGS, counts=(144, 16, 9, STAND_IN_EPISODE), per_step=DV3_CELL_LAUNCHES_PER_STEP,
                       log_steps=(64, 128, 144), learning_starts=128,
                       buffer=lambda ckpt: _check_sequential_buffer(ckpt, RUN_XL_ARGS, tuple(CRAFTER_OBS)),
                       obs=CRAFTER_OBS, continuous=False, actions=CRAFTER_ACTIONS),
    # (updates, player steps, gradient steps, test steps): 192 updates of 4 envs, 128 random ones up to learning_starts,
    # then 64 acting steps; 3 bursts of 8 (at updates 128, 160 and 192); a 5-step test episode; no cell kernel
    "run_dv1": dict(args=RUN_DV1_ARGS, counts=(192, 64, 24, 5), per_step=0, log_steps=(256, 512, 768),
                    learning_starts=512, buffer=_check_sequential_buffer, obs=OBS, continuous=False, cell=False),
}


def phase_run(card: str, name: str = "run", keep_root=None):
    """A main path: a training run through ``sheeprl_tpu_torch.cli.run``
    (``RUN_SPECS[name]``: the DreamerV2 MsPacman preset with its episode
    buffer, the DreamerV3 100k MsPacman preset or the DreamerV3 DMC walker
    preset with its sequential buffer, each at full width with logging), its
    gradient steps and acting steps replayed from CUDA graphs; its event
    file read back, its checkpoint validated (its buffer restored equal),
    and that checkpoint served (``load_gateway_model``) to RUN_CLIENTS
    lockstep clients, against a plain-cell replay (the walker's float
    actions within TOL_CONTINUOUS_ACTION, and its greedy best-of-100 actions
    too, ``_greedy_against_plain``). The cell's launches on the run must be the
    player steps + the cell steps of each gradient step (65 DV2, 79 DV3) +
    the test episode's steps. The run is traced (``torch.profiler``, CUDA
    activity only), so its rates are read under the profiler: the trace
    gives the device's busy time, its idle share over the run's wall time,
    and the number of the cell's gate kernels the device ran, which must
    equal the run's counters. The run writes under
    ``keep_root`` when given (its checkpoint outlives the phase). Returns
    the run's launches and its checkpoint."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.ckpt import validate_checkpoint
    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.serve.model import load_gateway_model
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    spec = RUN_SPECS[name]
    stamps = [("start", time.perf_counter())]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_run_") as tmp:
        root = keep_root or tmp
        torch.cuda.reset_peak_memory_stats()
        ops.hafner_cell_launches.reset()
        ops.hafner_sequence_launches.reset()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            result, wall = _run_once(root, name, spec["args"])
        launches = {"hafner_cell": ops.hafner_cell_launches.count, "hafner_sequence": ops.hafner_sequence_launches.count}
        peak = torch.cuda.max_memory_allocated()

        counts = (result["updates"], result["player_steps"], result["gradient_steps"], result["test_steps"])
        if counts != spec["counts"]:
            raise AssertionError(f"the {name} took (updates, player, gradient, test) steps {counts}")
        cell = spec.get("cell", True)
        predicted = result["player_steps"] + spec["per_step"] * result["gradient_steps"] + result["test_steps"]
        predicted = predicted if cell else 0
        if launches["hafner_cell"] != predicted:
            raise AssertionError(f"hafner_cell launched {launches['hafner_cell']} times on the run, predicted {predicted}")
        if launches["hafner_sequence"] != 0:
            raise AssertionError(f"the sequence kernel launched {launches['hafner_sequence']} times on the run")
        graphs = result["graphs"]
        want_graphs = {
            "train": {"eager_calls": WARMUP_CALLS, "replays": spec["counts"][2] - WARMUP_CALLS, "captured": 1},
            "act": {"eager_calls": WARMUP_CALLS, "replays": spec["counts"][1] - WARMUP_CALLS, "captured": 1},
        }
        if {k: {n: v[n] for n in want_graphs[k]} for k, v in graphs.items()} != want_graphs:
            raise AssertionError(f"the run's steps ran as {graphs}, expected {want_graphs}")
        stamps.append(("run", time.perf_counter()))
        events = _check_events(result, spec)

        ckpt = result["checkpoint"]
        if ckpt is None or not ckpt.endswith(f"ckpt_{result['policy_steps']}_0"):
            raise AssertionError(f"the run's last checkpoint is {ckpt}")
        manifest = validate_checkpoint(ckpt, deep=True)
        ckpt_bytes = sum(manifest["files"].values())
        replay = spec["buffer"](ckpt)
        f32_parameters = _f32_parameters(ckpt)

        stamps.append(("checks", time.perf_counter()))
        t0 = time.perf_counter()
        model, _cfg, _obs_space, _act_space = load_gateway_model(ckpt, device="cuda")
        torch.cuda.synchronize()
        cold_start_s = time.perf_counter() - t0
        frames = _serve_frames(spec["obs"], np.random.RandomState(SEED))
        ops.hafner_cell_launches.reset()
        actions, states, serve_wall, status = serve_lockstep(model, frames, seed=SEED)
        served_launches = ops.hafner_cell_launches.count
        if cell:  # the kernel path against a plain-cell replay
            plain, *_ = load_gateway_model(ckpt, device="cuda", plain_cell=True)
            p_actions, p_states, _w, p_status = serve_lockstep(plain, frames, seed=SEED)
            del plain
        else:  # no kernel: the served actions against the evaluation policy's on the same frames and noise
            p_actions, p_states = eval_policy_lockstep(ckpt, frames, seed=SEED)
            p_status = {"failed_requests": 0}
        requests = RUN_CLIENTS * RUN_REQUESTS
        if status["failed_requests"] or p_status["failed_requests"] or status["requests"] != requests:
            raise AssertionError(f"served {status['requests']} requests, {status['failed_requests']} failed")
        if spec["continuous"]:
            in_range = np.isfinite(actions).all() and np.abs(actions).max() <= 1.0
            action_err = float(np.abs(actions - p_actions).max())
            agree = action_err <= TOL_CONTINUOUS_ACTION
        else:
            in_range = ((actions >= 0) & (actions < spec.get("actions", RUN_ACTIONS))).all()
            action_err = float((actions != p_actions).sum())
            agree = action_err == 0
        if not in_range or not torch.isfinite(states).all():
            raise AssertionError("an action is out of range or a recurrent state is not finite")
        if not agree:
            raise AssertionError(f"the checkpoint's kernel and plain paths disagree on the actions: {action_err}")
        greedy = _greedy_against_plain(ckpt) if spec["continuous"] else None
        state_err = (states - p_states).abs().max().item()
        if state_err > TOL_STATE:
            raise AssertionError(f"recurrent state differs by {state_err} > {TOL_STATE}")
        if served_launches != (status["batches"] if cell else 0):
            raise AssertionError(f"hafner_cell launched {served_launches} times for {status['batches']} batches")
        del model
        stamps.append(("serve", time.perf_counter()))

        busy_us, found = trace_summary(prof, ("hafner_gates_kernel", "hafner_product_kernel"))
        stamps.append(("trace_read", time.perf_counter()))
        gate_kernels, product_kernels = found["hafner_gates_kernel"], found["hafner_product_kernel"]
        if gate_kernels != launches["hafner_cell"]:
            raise AssertionError(
                f"the trace holds {gate_kernels} hafner_gates_kernel runs, the counters {launches['hafner_cell']} launches"
            )

    seconds = result["seconds"]
    stats = result["checkpoint_stats"]
    # the run's host time by phase, the graphed phases split into their warm-up calls, capture and replays,
    # ranked; set-up and drain is the wall time no phase holds (config, envs, buffer, logger, writer join)
    host_s = {k: v for k, v in seconds.items() if k not in graphs}
    for phase, counts in graphs.items():
        host_s.update({f"{phase}_warmup": counts["warmup_s"], f"{phase}_capture": counts["capture_s"],
                       f"{phase}_replays": seconds[phase] - counts["warmup_s"] - counts["capture_s"]})
    host_s["setup_and_drain"] = wall - sum(seconds.values())
    line = {
        "run_args": list(spec["args"]),
        "updates": result["updates"],
        "policy_steps": result["policy_steps"],
        "player_steps": result["player_steps"],
        "random_steps": result["random_steps"],
        "gradient_steps": result["gradient_steps"],
        "test_steps": result["test_steps"],
        "graphs": graphs,
        "wall_s": wall,
        "policy_steps_per_s": result["policy_steps"] / wall,
        "gradient_steps_per_s": result["gradient_steps"] / seconds["train"],
        "pr5_rates_at_its_cuts": PR5_RATES if name == "run" else None,
        "seconds": seconds,
        "host_seconds_ranked": sorted(host_s.items(), key=lambda kv: -kv[1]),
        "prefetch": result["prefetch"],
        "hafner_cell_launches": launches["hafner_cell"],
        "hafner_cell_launches_predicted": predicted,
        "hafner_sequence_launches": launches["hafner_sequence"],
        "gate_kernels_in_trace": gate_kernels,
        "product_kernels_in_trace": product_kernels,
        "event_file": events,
        "checkpoint_bytes": ckpt_bytes,
        "checkpoint_buffer": replay,
        "checkpoint_parameters": f32_parameters,
        "checkpoint_write_ms": stats["write_ms"],
        "checkpoint_blocked_ms": stats["blocked_ms"],
        "load_gateway_model_cold_start_s": cold_start_s,
        "served_requests": requests,
        "served_failed_requests": status["failed_requests"],
        "served_requests_per_s": requests / serve_wall,
        "served_against": "plain_replay" if cell else "eval_policy",
        "plain_replay_actions_equal": not spec["continuous"],
        "plain_replay_action_max_abs_err" if spec["continuous"] else "plain_replay_actions_differing": action_err,
        "plain_replay_state_max_abs_err": state_err,
        "greedy_best_of_samples": greedy,
        "peak_device_memory_bytes": peak,
        # the phase's own seconds, part by part (the run's includes stopping the profiler)
        "phase_seconds": {k: t - stamps[i][1] for i, (k, t) in enumerate(stamps[1:])},
        "device_busy_s": busy_us / 1e6,
        # over the traced run's wall time (the profiler adds host time, so this share is an upper bound on an
        # untraced run's)
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "rates_under_profiler": True,
        "card": card,
    }
    print(f"[{name}] " + json.dumps(line), flush=True)
    return launches, ckpt


# the eval_serve phase: the port's evaluation, registration and serve commands on run_dv3's and run_walker's
# checkpoints, then in-run evaluation on a short DV3 run at the 100k preset's full width
EVAL_EPISODES, EVAL_SEED0 = 10, 1000  # eval.episodes and eval.seed0 as shipped (configs/eval/default.yaml)
# the keys of the JAX package's eval result (sheeprl_tpu/evals/service.py EvalService.run); its eval.json has all but "path"
EVAL_JSON_KEYS = {"schema", "algo", "env", "run", "checkpoint", "config_hash", "policy_version", "protocol", "n",
                  "seed0", "seeds", "returns", "lengths", "mean", "std", "iqm", "min", "max", "path"}
# the serve command's load: SERVE_CLIENTS spawned ring clients; once every one has an answer, the weights are published
# SERVE_PUBLISH_AFTER_S later and the clients stopped SERVE_STOP_AFTER_S after that (SERVE_CLIENT_CAP_S caps a client)
SERVE_CLIENTS, SERVE_PUBLISH_AFTER_S, SERVE_STOP_AFTER_S, SERVE_CLIENT_CAP_S = 64, 2.0, 4.0, 90.0
SERVE_VERSION_STEP = 1000  # the published version: the checkpoint's step + this
# the in-run run: RUN_DV3_ARGS cut to 160 policy steps, learning from 128 (33 gradient steps), a publication every 16
INRUN_ARGS = tuple(a for a in RUN_DV3_ARGS if not a.startswith(("total_steps=", "buffer.size="))) + (
    "buffer.size=1024", "algo.learning_starts=128", "total_steps=160", "eval.every_n_steps=16", "eval.inrun_episodes=2",
)


class _RecordingBuilder:
    """Within the block, the registered eval builder of ``algo`` keeps each
    act's actions and host time (``steps``) and, with ``plain_cell``, builds
    the policy on the cell's plain version."""

    def __init__(self, algo: str, plain_cell: bool = False):
        self.algo, self.plain_cell, self.steps = algo, plain_cell, []

    def __enter__(self):
        import numpy as np

        import sheeprl_tpu_torch
        from sheeprl_tpu_torch.evals import service

        sheeprl_tpu_torch.register_algorithms()
        self._service = service
        self._original = service._EVAL_BUILDERS[self.algo]

        def build(*args, **kwargs):
            policy = self._original(*args, plain_cell=self.plain_cell, **kwargs)

            def act(obs, state, generator):
                actions, state = policy.act(obs, state, generator)
                self.steps.append((time.perf_counter(), np.asarray(actions).copy()))
                return actions, state

            return service.EvalPolicy(act=act, init_state=policy.init_state, device=policy.device)

        service._EVAL_BUILDERS[self.algo] = build
        return self

    def __exit__(self, *exc):
        self._service._EVAL_BUILDERS[self.algo] = self._original
        return False

    def actions(self):
        import numpy as np

        return np.stack([a for _t, a in self.steps])

    def steps_per_s(self) -> float:
        """Pool steps a second from the first act to the last."""
        return (len(self.steps) - 1) / (self.steps[-1][0] - self.steps[0][0])


def _registry_lines(reg: str) -> int:
    path = os.path.join(reg, "registry.jsonl")
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return sum(1 for line in f if line.strip())


def _eval_command(name: str, ckpt: str, algo: str, reg: str, continuous: bool, pinned: bool = False,
                  cell: bool = True) -> dict:
    """``cli.evaluation`` of ``ckpt`` at eval.episodes=10 on the card: eval.json
    with the JAX keys, one registry line, cell launches equal to the pool
    steps (0 without ``cell``: DreamerV1's GRU has no kernel, and its
    "plain-cell" evaluation is a second evaluation on the same path), and
    every pool step's actions against a plain-cell evaluation at the same
    seeds (equal; continuous ones within TOL_CONTINUOUS_ACTION).
    ``pinned`` (a bf16 checkpoint): the plain evaluation takes the kernel
    one's posterior samples and greedy actions (``_PinnedSamples``), at most
    TOL_FLIPS_BF16 of which its own scores would have flipped."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.evals.service import evaluate_checkpoint
    from sheeprl_tpu_torch.kernels import ops

    lines = _registry_lines(reg)
    pins = _PinnedSamples(greedy=True) if pinned else contextlib.nullcontext()
    with pins, _RecordingBuilder(algo) as kernel:
        ops.hafner_cell_launches.reset()
        ops.hafner_sequence_launches.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = cli.evaluation([f"checkpoint_path={ckpt}", f"eval.episodes={EVAL_EPISODES}",
                                 f"eval.seed0={EVAL_SEED0}", f"eval.registry_dir={reg}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"hafner_cell": ops.hafner_cell_launches.count,
                    "hafner_sequence": ops.hafner_sequence_launches.count}
    if pinned:
        pins.replay = True
    with pins, _RecordingBuilder(algo, plain_cell=True) as plain:
        p_result = evaluate_checkpoint(ckpt, episodes=EVAL_EPISODES, seed0=EVAL_SEED0, write_registry=False)
    flips = {"samples": pins.samples, "flips": pins.flips} if pinned else None
    if pinned and (pins.index != len(pins.choices) or pins.flips > TOL_FLIPS_BF16 * pins.samples):
        raise AssertionError(f"{name}: pinned samples {pins.index} of {len(pins.choices)}, {pins.flips} flips")
    with open(result["path"]) as f:
        written = json.load(f)
    if set(result) != EVAL_JSON_KEYS or set(written) != EVAL_JSON_KEYS - {"path"} or written["returns"] != result["returns"]:
        raise AssertionError(f"{name}: eval.json holds {sorted(written)}, the JAX package's {sorted(EVAL_JSON_KEYS)}")
    if _registry_lines(reg) != lines + 1:
        raise AssertionError(f"{name}: the registry went from {lines} to {_registry_lines(reg)} lines, not one more")
    steps = len(kernel.steps)
    if steps != max(result["lengths"]) or launches["hafner_cell"] != (steps if cell else 0) or (
            launches["hafner_sequence"]):
        raise AssertionError(f"{name}: {steps} pool steps, longest episode {max(result['lengths'])}, "
                             f"cell launches {launches}")
    actions, p_actions = kernel.actions(), plain.actions()
    if actions.shape != p_actions.shape or not np.isfinite(actions).all():
        raise AssertionError(f"{name}: actions {actions.shape} against the plain cell's {p_actions.shape}")
    err = float(np.abs(actions - p_actions).max()) if continuous else float((actions != p_actions).sum())
    if err > (TOL_CONTINUOUS_ACTION if continuous else 0):
        raise AssertionError(f"{name}: the kernel and plain-cell evaluations' actions differ by {err}")
    if not continuous and (result["returns"] != p_result["returns"] or result["lengths"] != p_result["lengths"]):
        raise AssertionError(f"{name}: the kernel and plain-cell evaluations' returns differ")
    row = {"checkpoint": ckpt, "n": result["n"], "returns": result["returns"], "lengths": result["lengths"],
           "mean": result["mean"], "iqm": result["iqm"], "policy_version": result["policy_version"],
           "config_hash": result["config_hash"], "pool_steps": steps, "hafner_cell_launches": launches["hafner_cell"],
           "pool_steps_per_s": kernel.steps_per_s(), "plain_cell_pool_steps_per_s": plain.steps_per_s(),
           "command_wall_s": wall, "pinned_samples": flips,
           "plain_cell_action_max_abs_err" if continuous else "plain_cell_actions_differing": err}
    return {"row": row, "launches": launches, "actions": actions, "result": result}


def _serve_command(ckpt_ref: str, reg: str, base_ckpt: str, work: str) -> dict:
    """The serve command in a subprocess (``cli.serve`` with serve.duration_s
    as a limit), its ring driven by SERVE_CLIENTS spawned seeded clients.
    Once every client has had an answer, the steady window starts;
    SERVE_PUBLISH_AFTER_S seconds into it perturbed weights are published
    into the watched ``poll_root``, SERVE_STOP_AFTER_S seconds later the
    clients are stopped (a stop file), and once every client has written its
    record the command gets SIGTERM. Requests/s and latency are read over the
    steady window."""
    import signal
    import threading

    import numpy as np

    from sheeprl_tpu_torch.ckpt import read_checkpoint
    from sheeprl_tpu_torch.evals.service import policy_version_of
    from sheeprl_tpu_torch.plane.publish import PolicyPublisher

    repo = os.path.dirname(os.path.abspath(__file__))
    pol, out = os.path.join(work, "policies"), os.path.join(work, "clients")
    base = policy_version_of(base_ckpt)
    cmd = [sys.executable, "-c", "import sys; from sheeprl_tpu_torch.cli import serve; serve(sys.argv[1:])",
           f"checkpoint_path={ckpt_ref}", f"serve.registry_dir={reg}", "serve.duration_s=150",
           f"serve.max_clients={SERVE_CLIENTS}", f"serve.poll_root={pol}", "serve.poll_interval_s=0.2",
           f"serve.clients.n={SERVE_CLIENTS}", "serve.clients.entry=sheeprl_tpu_torch.serve.loadgen:seeded_client",
           f"serve.clients.spec.duration_s={SERVE_CLIENT_CAP_S}", f"serve.clients.spec.out_dir={out}",
           f"serve.clients.spec.stop_file={os.path.join(out, 'stop')}", f"serve.clients.spec.seed={SEED}"]
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, up = [], threading.Event()

    def pump():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "[serve] gateway up" in line:
                up.set()

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        if not up.wait(180.0):
            raise AssertionError("the serve command did not come up: " + " | ".join(lines[-20:]))
        t_up, t_up_wall = time.perf_counter(), time.time()
        agent = read_checkpoint(base_ckpt, with_rb=False)["agent"]
        rng = np.random.default_rng(SEED)
        actor = {k: v + 0.01 * rng.standard_normal(v.shape).astype(v.dtype) if v.dtype.kind == "f" else v
                 for k, v in agent["actor"].items()}
        def wait_for(suffix: str, what: str):
            deadline = time.perf_counter() + 120.0
            while len([f for f in os.listdir(out) if f.endswith(suffix)] if os.path.isdir(out) else []) < SERVE_CLIENTS:
                if time.perf_counter() > deadline or proc.poll() is not None:
                    raise AssertionError(f"the serve clients did not all {what}: " + " | ".join(lines[-20:]))
                time.sleep(0.05)

        wait_for(".started", "start")
        t_all = time.time()
        time.sleep(SERVE_PUBLISH_AFTER_S)
        new_version = base + SERVE_VERSION_STEP
        PolicyPublisher(pol, algo="dreamer_v3").publish(
            new_version, {"agent": {"world_model": agent["world_model"], "actor": actor}})
        t_publish = time.time()
        time.sleep(SERVE_STOP_AFTER_S)
        t_stop = time.time()
        open(os.path.join(out, "stop"), "w").close()
        wait_for(".json", "finish")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120.0)
        reader.join(timeout=10.0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30.0)
    finals = [line for line in lines if line.startswith("[serve] final ")]
    if rc != 0 or not finals or not any("drained=clean" in line for line in lines):
        raise AssertionError(f"the serve command exited {rc}: " + " | ".join(lines[-30:]))
    final = json.loads(finals[-1][len("[serve] final "):])
    records = []
    for slot in range(SERVE_CLIENTS):
        with open(os.path.join(out, f"client_{slot}.json")) as f:
            records.append(json.load(f))
    errors = [e for r in records for e in r["errors"]]
    versions_ok = all(r["versions"] == sorted(r["versions"]) and r["versions"] for r in records)
    requests = sum(len(r["versions"]) for r in records)
    if errors or final["failed_requests"] or requests != final["requests"] or not versions_ok:
        raise AssertionError(f"serve: {len(errors)} client errors ({errors[:3]}), {final['failed_requests']} failed, "
                             f"{requests} answered of {final['requests']}, versions monotone {versions_ok}")
    if final["swaps"] < 1 or final["versions_served"] != [base, new_version]:
        raise AssertionError(f"serve: {final['swaps']} swaps, versions served {final['versions_served']}")
    if any(r["torch_loaded"] for r in records):
        raise AssertionError("a ring client process loaded torch")
    launches = final["kernel_launches"]
    if launches["hafner_cell"] != final["batches"] or launches["hafner_sequence"]:
        raise AssertionError(f"serve: cell launches {launches} for {final['batches']} batches")
    steady = [(t, x) for r in records for t, x in zip(r["answered_at"], r["latency_s"]) if t_all <= t <= t_stop]
    latency_ms = 1e3 * np.array([x for _t, x in steady])
    new_at = [t for r in records for t, v in zip(r["answered_at"], r["versions"]) if v == new_version]
    row = {"clients": SERVE_CLIENTS, "steady_window_s": t_stop - t_all, "requests": requests,
           "steady_requests": len(steady), "requests_per_s": len(steady) / (t_stop - t_all),
           "act_latency_p50_ms": float(np.percentile(latency_ms, 50)),
           "act_latency_p99_ms": float(np.percentile(latency_ms, 99)),
           "batches": final["batches"], "mean_batch_occupancy": final["mean_batch_occupancy"],
           "deadline_misses": final["deadline_misses"], "swaps": final["swaps"],
           "versions_served": final["versions_served"],
           "publish_to_first_new_version_s": min(new_at) - t_publish,
           "requests_at_new_version": len(new_at), "drain_s": final["drain_s"], "serving_s": final["serving_s"],
           "server_act_latency": final["act_latency"], "server_stage_latency": final["stage_latency"],
           "hafner_cell_launches": launches["hafner_cell"], "start_to_up_s": t_up - t_start,
           "up_to_all_clients_answered_s": t_all - t_up_wall}
    return {"row": row, "launches": launches}


def phase_eval_serve(card: str, work: str, dv3_ckpt: str, walker_ckpt: str):
    """The eval and serve paths: the evaluation command on run_dv3's and
    run_walker's checkpoints (``_eval_command``), the registration command
    and the gateway-path rescore of ``registry:best:dreamer_v3:<env>``
    (returns, lengths and every step's actions bit for bit the evaluation's,
    one cell launch a batch), the cold start through that ref, the serve
    command under load with a hot-swap and a SIGTERM drain
    (``_serve_command``), and in-run evaluation on a short DV3 run
    (INRUN_ARGS: the sidecar's curve, the spawned CPU child never opening a
    CUDA context, the trainer's launches still player steps + 79 a gradient
    step + test steps). Returns each path's launches."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.serve import ServeGateway, rescore_through_gateway
    from sheeprl_tpu_torch.utils.model_manager import ModelManager

    stamps = [("start", time.perf_counter())]
    reg = os.path.join(work, "registry")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        dv3 = _eval_command("eval_dv3", dv3_ckpt, "dreamer_v3", reg, continuous=False)
        walker = _eval_command("eval_walker", walker_ckpt, "dreamer_v3", reg, continuous=True)
        stamps.append(("evaluation", time.perf_counter()))

        models = os.path.join(work, "models")
        version = cli.registration([f"checkpoint_path={dv3_ckpt}", "model_name=dv3_100k", f"registry_dir={models}"])
        meta = ModelManager(models).get_metadata("dv3_100k")
        if version != 1 or meta["source_checkpoint"] != os.path.abspath(dv3_ckpt):
            raise AssertionError(f"registration gave version {version}, metadata {meta}")
        ref = f"registry:best:dreamer_v3:{dv3['result']['env']}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gateway = ServeGateway.from_checkpoint(ref, registry_dir=reg)
        torch.cuda.synchronize()
        cold_start_s = time.perf_counter() - t0
        if gateway.status()["checkpoint"] != os.path.abspath(dv3_ckpt):
            raise AssertionError(f"{ref} resolved to {gateway.status()['checkpoint']}")
        gateway.close()
        steps = []
        ops.hafner_cell_launches.reset()
        ops.hafner_sequence_launches.reset()
        gated = rescore_through_gateway(ref, episodes=EVAL_EPISODES, seed0=EVAL_SEED0, registry_dir=reg,
                                        on_step=lambda a: steps.append(a.copy()))
        rescore_launches = {"hafner_cell": ops.hafner_cell_launches.count,
                            "hafner_sequence": ops.hafner_sequence_launches.count}
        direct = dv3["result"]
        if gated["returns"] != direct["returns"] or gated["lengths"] != direct["lengths"]:
            raise AssertionError(f"rescore: returns {gated['returns']} lengths {gated['lengths']} against the "
                                 f"evaluation's {direct['returns']} {direct['lengths']}")
        if not np.array_equal(np.stack(steps).reshape(dv3["actions"].shape), dv3["actions"]):
            raise AssertionError("rescore: the per-step actions differ from the evaluation's")
        if gated["failed_requests"] or not rescore_launches["hafner_cell"] == gated["batches"] == len(steps):
            raise AssertionError(f"rescore: {gated['batches']} batches, {len(steps)} steps, launches {rescore_launches}")
        stamps.append(("registration_rescore", time.perf_counter()))

        serve = _serve_command(ref, reg, dv3_ckpt, work)
        stamps.append(("serve", time.perf_counter()))

        ops.hafner_cell_launches.reset()
        ops.hafner_sequence_launches.reset()
        result, wall = _run_once(work, "inrun", INRUN_ARGS)
        inrun_launches = {"hafner_cell": ops.hafner_cell_launches.count,
                          "hafner_sequence": ops.hafner_sequence_launches.count}
        predicted = result["player_steps"] + DV3_CELL_LAUNCHES_PER_STEP * result["gradient_steps"] + result["test_steps"]
        if inrun_launches["hafner_cell"] != predicted or inrun_launches["hafner_sequence"]:
            raise AssertionError(f"the in-run eval run launched {inrun_launches}, predicted {predicted} cell launches")
        with open(os.path.join(result["log_dir"], "telemetry", "sidecar_evalproc.json")) as f:
            curve = json.load(f)
        published = sorted(os.listdir(os.path.join(result["log_dir"], "inrun_policies")))
        if (result["inrun_publishes"] < 2 or not curve["points"] or curve["cuda_initialized"]
                or f"policy_{curve['last_policy_version']:08d}" != published[-1]
                or not all(np.isfinite(p["mean"]) for p in curve["points"])):
            raise AssertionError(f"in-run eval: {result['inrun_publishes']} publications, kept {published}, "
                                 f"sidecar {curve}")
        stamps.append(("inrun", time.perf_counter()))
    finally:
        os.chdir(cwd)
    line = {
        "eval_dv3": dv3["row"],
        "eval_walker": walker["row"],
        "registration_version": version,
        "registry_ref": ref,
        "from_checkpoint_registry_ref_cold_start_s": cold_start_s,
        "rescore": {"returns_lengths_actions_bitwise_equal": True, "versions_served": gated["versions_served"],
                    "batches": gated["batches"], "mean_batch_occupancy": gated["mean_batch_occupancy"],
                    "hafner_cell_launches": rescore_launches["hafner_cell"],
                    "cudnn_deterministic": torch.backends.cudnn.deterministic},
        "serve": serve["row"],
        "inrun": {"run_args": list(INRUN_ARGS), "wall_s": wall, "player_steps": result["player_steps"],
                  "gradient_steps": result["gradient_steps"], "test_steps": result["test_steps"],
                  "hafner_cell_launches": inrun_launches["hafner_cell"], "predicted": predicted,
                  "publishes": result["inrun_publishes"], "sidecar_points": curve["points"],
                  "child_cuda_initialized": curve["cuda_initialized"]},
        "phase_seconds": {k: t - stamps[i][1] for i, (k, t) in enumerate(stamps[1:])},
        "card": card,
    }
    print("[eval_serve] " + json.dumps(line), flush=True)
    return {"eval_dv3": dv3["launches"], "eval_walker": walker["launches"], "rescore": rescore_launches,
            "serve_command": serve["launches"], "inrun_run": inrun_launches}


# tags the P2E runs' last log boundary must hold (each run's own metrics; every value finite)
P2E_TAGS = {
    "p2e_dv3_exploration": ("Loss/world_model_loss", "Loss/ensemble_loss", "Loss/policy_loss_exploration",
                            "Loss/value_loss_exploration_intrinsic", "Loss/value_loss_exploration_extrinsic",
                            "Loss/policy_loss_task", "Loss/value_loss_task", "Rewards/intrinsic_intrinsic",
                            "Grads/ensemble", "Grads/actor_exploration"),
    "p2e_dv2_exploration": ("Loss/world_model_loss", "Loss/ensemble_loss", "Loss/policy_loss_exploration",
                            "Loss/value_loss_exploration", "Loss/policy_loss_task", "Loss/value_loss_task",
                            "Rewards/intrinsic", "Grads/ensemble", "Grads/critic_exploration"),
    "p2e_dv3_finetuning": ("Loss/world_model_loss", "Loss/policy_loss", "Loss/value_loss", "Grads/actor"),
    "p2e_dv3_L_bf16_exploration": ("Loss/world_model_loss", "Loss/ensemble_loss", "Loss/policy_loss_exploration",
                                   "Loss/value_loss_exploration_intrinsic", "Loss/value_loss_exploration_extrinsic",
                                   "Loss/policy_loss_task", "Loss/value_loss_task", "Rewards/intrinsic_intrinsic",
                                   "Grads/ensemble", "Grads/actor_exploration"),
    "p2e_dv3_L_bf16_finetuning": ("Loss/world_model_loss", "Loss/policy_loss", "Loss/value_loss", "Grads/actor"),
    "p2e_dv2_finetuning": ("Loss/world_model_loss", "Loss/policy_loss", "Loss/value_loss", "Grads/actor"),
    "p2e_dv1_exploration": ("Loss/world_model_loss", "Loss/ensemble_loss", "Loss/policy_loss_exploration",
                            "Loss/value_loss_exploration", "Loss/policy_loss_task", "Loss/value_loss_task",
                            "Rewards/intrinsic", "Grads/ensemble", "Grads/actor_exploration"),
    "p2e_dv1_finetuning": ("Loss/world_model_loss", "Loss/policy_loss", "Loss/value_loss", "Grads/actor"),
}


def _check_p2e_run(tag: str, result, counts, per_step: int, cell: bool = True) -> dict:
    """A P2E run's counters against ``counts`` (updates, random steps, player
    steps by actor, gradient steps, test steps, the update of the actor
    switch), its cell launches against the prediction (0 without ``cell``:
    P2E-DV1's GRU has no kernel), its graphs (one captured acting step per
    actor), its event file's tags (finite) and its checkpoint
    (deep-validated)."""
    import math

    from sheeprl_tpu_torch.ckpt import validate_checkpoint
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS
    from sheeprl_tpu_torch.utils.tb_events import read_events

    updates, random_steps, by_actor, gradient, test, switch = counts
    got = (result["updates"], result["random_steps"], result["player_steps_by_actor"], result["gradient_steps"],
           result["test_steps"], result["actor_switched_at"])
    if got != tuple(counts):
        raise AssertionError(f"{tag}: (updates, random, by actor, gradient, test, switch) {got}, expected {counts}")
    predicted = sum(by_actor) + per_step * gradient + test if cell else 0
    want_graphs = {
        "train": {"eager_calls": WARMUP_CALLS, "replays": gradient - WARMUP_CALLS, "captured": 1},
        "act": {"eager_calls": WARMUP_CALLS * len(by_actor), "replays": sum(by_actor) - WARMUP_CALLS * len(by_actor),
                "captured": len(by_actor)},
    }
    graphs = {k: {n: v[n] for n in want_graphs[k]} for k, v in result["graphs"].items()}
    if graphs != want_graphs:
        raise AssertionError(f"{tag}: the steps ran as {result['graphs']}, expected {want_graphs}")
    last = {}
    for e in read_events(result["event_file"])[1:]:
        for v in e.get("values", []):
            if e["step"] > 0 and v.get("simple_value") is not None:
                if not math.isfinite(v["simple_value"]):
                    raise AssertionError(f"{tag}: {v['tag']} at policy step {e['step']} is not finite")
                if e["step"] == result["policy_steps"]:
                    last[v["tag"]] = v["simple_value"]
    missing = [t for t in P2E_TAGS[tag] if t not in last]
    if missing:
        raise AssertionError(f"{tag}: the last log boundary lacks {missing}")
    ckpt = result["checkpoint"]
    manifest = validate_checkpoint(ckpt, deep=True)
    return {"predicted_cell_launches": predicted, "graphs": result["graphs"], "checkpoint": ckpt,
            "checkpoint_bytes": sum(manifest["files"].values()), "checkpoint_parameters": _f32_parameters(ckpt),
            "tags_at_last_log": len(last),
            "last_losses": {t: last[t] for t in P2E_TAGS[tag]}}


def phase_run_p2e(card: str, family: str, work: str):
    """Plan2Explore's main path through ``sheeprl_tpu_torch.cli.run`` at the
    preset's full width (RUN_P2E_SPECS[family]): the exploration run, then
    the finetuning run from its checkpoint, whose player switches from the
    exploration actor to the task actor inside the run; each run's cell
    launches equal to its counters' prediction (acting steps, P2E_STEP_LAUNCHES
    or P2E_FINETUNING_STEP_LAUNCHES a gradient step, test steps), checked
    one run at a time; the exploration run is traced (its rates read under
    the profiler), and its trace holds as many gate kernels as its counters.
    Then the ``evaluation``
    command on the finetuning checkpoint (``_eval_command``: actions equal
    to a plain-cell evaluation's) and ``load_gateway_model`` serving its task
    actor to RUN_CLIENTS lockstep clients, equal to a plain-cell replay.
    Returns the launches by path."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.serve.model import load_gateway_model

    spec = RUN_P2E_SPECS[family]
    cell = spec.get("cell", True)
    root = os.path.join(work, f"run_{family}")
    by_path, lines = {}, {}
    ckpt = None
    for phase in ("exploration", "finetuning"):
        tag = f"{family}_{phase}"
        args = spec[phase] + (() if ckpt is None else (f"checkpoint.exploration_ckpt_path={ckpt}",))
        per_step = P2E_STEP_LAUNCHES[family] if phase == "exploration" else P2E_FINETUNING_STEP_LAUNCHES[family]
        torch.cuda.reset_peak_memory_stats()
        ops.hafner_cell_launches.reset()
        ops.hafner_sequence_launches.reset()
        traced = phase == "exploration"
        with (profile(activities=[ProfilerActivity.CUDA]) if traced else contextlib.nullcontext()) as prof:
            result, wall = _run_once(root, tag, args)
        if traced:
            exploration_prof = prof
        launches = {"hafner_cell": ops.hafner_cell_launches.count, "hafner_sequence": ops.hafner_sequence_launches.count}
        bf16_launches = ops.hafner_cell_launches.by_variant.get("bf16", 0)
        line = _check_p2e_run(tag, result, spec[f"{phase}_counts"], per_step, cell)
        if launches != {"hafner_cell": line["predicted_cell_launches"], "hafner_sequence": 0}:
            raise AssertionError(f"{tag}: launches {launches}, predicted {line['predicted_cell_launches']} of the cell")
        ckpt = result["checkpoint"]
        by_path[f"run_{tag}"] = launches
        # a bf16-mixed preset's cell runs its bf16 operand path on every launch, an f32 preset's never
        if bf16_launches != (launches["hafner_cell"] if spec.get("bf16") else 0):
            raise AssertionError(f"{tag}: {bf16_launches} of {launches['hafner_cell']} cell launches took the bf16 path")
        line.update(run_args=list(args), wall_s=wall, policy_steps_per_s=result["policy_steps"] / wall,
                    hafner_cell_bf16_launches=bf16_launches,
                    gradient_steps_per_s=result["gradient_steps"] / result["seconds"]["train"],
                    seconds=result["seconds"], player_steps_by_actor=result["player_steps_by_actor"],
                    actor_switched_at=result["actor_switched_at"], hafner_cell_launches=launches["hafner_cell"],
                    peak_device_memory_bytes=torch.cuda.max_memory_allocated(), prefetch=result["prefetch"])
        lines[phase] = line

    explored = by_path[f"run_{family}_exploration"]["hafner_cell"]
    busy_us, found = trace_summary(exploration_prof, ("hafner_gates_kernel", "hafner_product_kernel"))
    if found["hafner_gates_kernel"] != explored:
        raise AssertionError(f"{family}: the trace holds {found['hafner_gates_kernel']} gate kernels, the counters "
                             f"{explored} launches")
    lines["exploration"].update(
        gate_kernels_in_trace=found["hafner_gates_kernel"], device_busy_s=busy_us / 1e6,
        # over the traced run's wall time: an upper bound on an untraced run's idle share
        device_idle_share=1.0 - busy_us / 1e6 / lines["exploration"]["wall_s"], rates_under_profiler=True,
    )

    algo = spec.get("algo", family)  # the runs' algorithm family (the L presets' is p2e_dv3)
    bf16 = bool(spec.get("bf16"))
    evaluated = _eval_command(f"{family}_finetuning eval", ckpt, f"{algo}_finetuning", os.path.join(work, "registry"),
                              False, pinned=bf16, cell=cell)
    by_path[f"eval_{family}"] = evaluated["launches"]

    model, cfg, *_ = load_gateway_model(ckpt, device="cuda")
    frames = _serve_frames(spec.get("obs", OBS), np.random.RandomState(SEED))
    ops.hafner_cell_launches.reset()
    ops.hafner_sequence_launches.reset()
    pins = _PinnedSamples(greedy=True) if bf16 else contextlib.nullcontext()
    with pins:
        actions, states, serve_wall, status = serve_lockstep(model, frames, seed=SEED)
    by_path[f"serve_{family}"] = {"hafner_cell": ops.hafner_cell_launches.count,
                                  "hafner_sequence": ops.hafner_sequence_launches.count}
    if bf16:
        pins.replay = True
    if cell:  # the kernel path against a plain-cell replay
        plain, *_ = load_gateway_model(ckpt, device="cuda", plain_cell=True)
        with pins:
            p_actions, p_states, _w, p_status = serve_lockstep(plain, frames, seed=SEED)
        del plain
    else:  # no kernel: the served actions against the evaluation policy's on the same frames and noise
        p_actions, p_states = eval_policy_lockstep(ckpt, frames, seed=SEED)
        p_status = {"failed_requests": 0}
    differing = int((actions != p_actions).sum())
    state_err = (states - p_states).abs().max().item()
    served_flips = {"samples": pins.samples, "flips": pins.flips} if bf16 else None
    if bf16 and (pins.index != len(pins.choices) or pins.flips > TOL_FLIPS_BF16 * pins.samples):
        raise AssertionError(f"{family}: served pinned samples {pins.index} of {len(pins.choices)}, {pins.flips} flips")
    if status["failed_requests"] or p_status["failed_requests"] or status["requests"] != RUN_CLIENTS * RUN_REQUESTS:
        raise AssertionError(f"{family}: served {status['requests']} requests, {status['failed_requests']} failed")
    if differing or state_err > (TOL_STATE_BF16 if bf16 else TOL_STATE) or not (
            (actions >= 0) & (actions < spec.get("actions", RUN_ACTIONS))).all():
        raise AssertionError(f"{family}: served actions differ from a plain-cell replay (or the evaluation policy's) "
                             f"in {differing}, state {state_err}")
    if by_path[f"serve_{family}"]["hafner_cell"] != (status["batches"] if cell else 0) or (
            model.algo != f"{algo}_finetuning"):
        raise AssertionError(f"{family}: served {model.algo}, cell launches {by_path[f'serve_{family}']} "
                             f"for {status['batches']} batches")
    del model
    against = "plain_replay" if cell else "eval_policy"
    line = {**lines, "eval": evaluated["row"],
            "serve": {"algo": f"{algo}_finetuning", "requests": status["requests"], "batches": status["batches"],
                      "requests_per_s": status["requests"] / serve_wall, f"{against}_actions_differing": differing,
                      f"{against}_state_max_abs_err": state_err, "pinned_samples": served_flips},
            "card": card}
    print(f"[run_{family}] " + json.dumps(line), flush=True)
    return by_path, line


class _PhaseClock:
    """Each phase's wall seconds (printed as the ``[timing]`` line): the
    script must stay inside its 1,200 s limit on a slow host."""

    def __init__(self):
        self.seconds, self.start = {}, time.perf_counter()

    def __call__(self, name: str, fn, *args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self.seconds[name] = round(self.seconds.get(name, 0.0) + time.perf_counter() - t, 1)
            print(f"[timing] {name} {time.perf_counter() - t:.1f} s (total {time.perf_counter() - self.start:.1f} s)",
                  flush=True)

    def line(self) -> dict:
        return {"total_s": round(time.perf_counter() - self.start, 1), "phases_s": self.seconds}


def main() -> int:
    import torch

    clock = _PhaseClock()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sheeprl_tpu_torch.kernels import build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}", flush=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[build] {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            # register and spill counts, and C7520 (ptxas serialising a kernel's wgmmas)
            if any(key in line for key in ("Used ", "spill", "C7520")) or "error" in line.lower():
                print(f"[build] {name}: {line.strip()}", flush=True)

    sass = build.tensor_core_instructions("hafner_gru")
    print(f"[build] hafner_gru tensor-core instructions in SASS (cuobjdump -sass): {json.dumps(sass)}", flush=True)
    if not any(form.startswith("HGMMA") for form in sass):
        raise AssertionError("the built library has no HGMMA (wgmma) instruction")

    serve_rows = clock("kernels", phase_kernels)
    train_rows = clock("cell_training", phase_cell_training)
    dv3_rows = clock("cell_dv3", phase_cell_dv3)
    p2e_rows = clock("cell_p2e", phase_cell_p2e)
    large_rows = clock("cell_l_xl", phase_cell_large)
    bf16_rows = clock("cell_bf16", phase_cell_bf16)
    seq_rows = clock("sequence", phase_sequence)
    # launches per kernel, read on each path's run with the counts zeroed just before it
    by_path = {"serve": clock("slice", phase_slice, card)}
    by_path["bench_kernels"], bench_line = clock("bench_kernels", phase_bench_kernels)
    by_path["train"], train_rel_diff, graph_line = clock("train", phase_train, card)
    by_path["train_dv3"], dv3_rel_diff, dv3_graph_line = clock("train_dv3", phase_train_dv3, card)
    by_path["train_walker"], walker_rel_diff, walker_graph_line = clock("train_walker", phase_train_dv3, card,
                                                                        "dreamer_v3_walker")
    by_path["train_dv2_continuous"], dv2_continuous_graph_line = clock("train_dv2_continuous",
                                                                       phase_train_dv2_continuous, card)
    p2e_train = {}
    for algo in ("p2e_dv3", "p2e_dv3_continuous", "p2e_dv2", "p2e_dv3_L_bf16"):
        by_path[f"train_{algo}"], rel_diff, graphed = clock(f"train_{algo}", phase_train_p2e, card, algo)
        p2e_train[algo] = {"train_step_rel_diff_vs_plain": rel_diff, "graphed_vs_eager_cudnn_deterministic": graphed}
    large_train = {}
    for algo in ("dreamer_v3_L", "dreamer_v3_XL"):
        tag = f"train_{algo.replace('dreamer_v', 'dv')}"
        by_path[tag], rel_diff, graphed = clock(tag, phase_train_dv3, card, algo)
        large_train[algo] = {"train_step_rel_diff_vs_plain": rel_diff, "graphed_vs_eager_cudnn_deterministic": graphed}
    dv1_train = {}
    for algo in ("dreamer_v1", "p2e_dv1"):
        tag = f"train_{algo.replace('dreamer_v', 'dv')}"
        by_path[tag], dv1_train[algo] = clock(tag, phase_train_dv1, card, algo)
    by_path["run"], _ckpt = clock("run", phase_run, card, "run")
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_serve_") as work:
        by_path["run_dv3"], dv3_ckpt = clock("run_dv3", phase_run, card, "run_dv3",
                                             keep_root=os.path.join(work, "run_dv3"))
        by_path["run_walker"], walker_ckpt = clock("run_walker", phase_run, card, "run_walker",
                                                   keep_root=os.path.join(work, "run_walker"))
        by_path.update(clock("eval_serve", phase_eval_serve, card, work, dv3_ckpt, walker_ckpt))
        for family in RUN_P2E_SPECS:
            paths, _line = clock(f"run_{family}", phase_run_p2e, card, family, work)
            by_path.update(paths)
    for name in ("run_dv1", "run_dv3_L", "run_dv3_XL"):
        by_path[name], _ckpt = clock(name, phase_run, card, name)

    cell_row = next(r for r in train_rows if r["B"] == 1600)
    bf16_row = next(r for r in bf16_rows["p2e_dv3_L"] if r["B"] == 1024)
    seq_row = seq_rows[0]
    if {v for r in seq_rows for v in r["variants"]} != {"persistent", "multi_launch"}:
        raise AssertionError("the run did not launch both variants of the sequence")
    kernels = [
        {
            "name": "hafner_cell",
            "route": "cuda",
            "source": "sheeprl_tpu_torch/kernels/csrc/hafner_gru.cu",
            "replaces": "sheeprl_tpu/kernels/pallas_tpu.py:67",
            # the main paths' f32 runs: the DV2 MsPacman preset's, the DV3 100k, walker, L and XL presets', the
            # DV1 preset's (0) and the f32 P2E presets' exploration and finetuning runs (P2E-DV1's 0; the bf16
            # presets' are hafner_cell_bf16's)
            "launches": sum(by_path[run]["hafner_cell"] for run in RUN_SPECS)
            + sum(by_path[f"run_{family}_{phase}"]["hafner_cell"] for family, spec in RUN_P2E_SPECS.items()
                  if not spec.get("bf16") for phase in ("exploration", "finetuning")),
            "max_abs_err": max(r["max_abs_err"] for r in serve_rows + train_rows + dv3_rows
                               + [row for rows in (*p2e_rows.values(), *large_rows.values()) for row in rows]),
            "ms": cell_row["ms"],
            "plain_ms": cell_row["plain_ms"],
            "bound_ms": cell_row["bound_ms"],
            "bound_by": cell_row["bound_by"],
            "library_ms": cell_row["cublas_product_ms"],
            "library": "cuBLAS f32 SGEMM of the product [h|x].W alone (torch.matmul, TF32 off)",
            "product_ms": cell_row["product_ms"],
            "gates_ms": cell_row["gates_ms"],
            "bound_f32_simt_ms": cell_row["bound_f32_simt_ms"],
            "variant": cell_row["variant"]["product"],
            "sass_tensor_core_instructions": sass,
            "shape": "B=1600 H=600 X=400 (imagination)",
            "launches_by_path": {path: counts["hafner_cell"] for path, counts in by_path.items()},
            "train_step_rel_diff_vs_plain": train_rel_diff,
            "graphed_vs_eager_train_steps_cudnn_deterministic": graph_line,
            "dv3_shapes": [
                {k: r[k] for k in ("B", "H", "X", "bias", "eps", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "cublas_product_ms", "max_abs_err", "grad_rel_err")}
                | {"variant": r["variant"]["product"], "product_ms": r.get("product_ms"), "gates_ms": r.get("gates_ms")}
                for r in dv3_rows
            ],
            "dv3_train_step_rel_diff_vs_plain": dv3_rel_diff,
            "dv3_graphed_vs_eager_train_steps_cudnn_deterministic": dv3_graph_line,
            # the VJP (plain PyTorch operations) at the walker's imagination shape, beside the kernel's forward
            "dv3_walker_vjp": next(r["vjp"] for r in dv3_rows if r["B"] == max(DV3_CELL_BATCHES)),
            "dv3_posterior_vjp": next(r["vjp"] for r in dv3_rows if r["B"] == 16),
            "walker_train_step_rel_diff_vs_plain": walker_rel_diff,
            "walker_graphed_vs_eager_train_steps_cudnn_deterministic": walker_graph_line,
            "dv2_continuous_graphed_vs_eager_cudnn_deterministic": dv2_continuous_graph_line,
            # Plan2Explore's presets' shapes (P2E-DV3: H = X = 256, no bias; P2E-DV2: H = X = 400, bias, eps 1e-5)
            "p2e_shapes": {
                name: [{k: r[k] for k in ("B", "H", "X", "bias", "eps", "ms", "plain_ms", "bound_ms", "bound_by",
                                          "cublas_product_ms", "max_abs_err", "grad_rel_err")}
                       | {"variant": r["variant"]["product"], "product_ms": r.get("product_ms"),
                          "gates_ms": r.get("gates_ms"), "vjp": r.get("vjp")}
                       for r in rows]
                for name, rows in p2e_rows.items()
            },
            "p2e_train": p2e_train,
            # the L and XL widths in f32 (H = 2048, X = 768; H = 4096, X = 1024; no bias, eps 1e-3)
            "l_xl_shapes": {
                name: [{k: r[k] for k in ("B", "H", "X", "bias", "eps", "ms", "plain_ms", "bound_ms", "bound_by",
                                          "cublas_product_ms", "max_abs_err", "grad_rel_err")}
                       | {"variant": r["variant"]["product"], "product_ms": r.get("product_ms"),
                          "gates_ms": r.get("gates_ms"), "vjp": r.get("vjp")}
                       for r in rows]
                for name, rows in large_rows.items()
            },
            "l_xl_train": large_train,
            # DreamerV1 and P2E-DV1: flax's GRU cell in PyTorch operations, every path of theirs at 0 launches
            "dv1_paths": {path: counts["hafner_cell"] for path, counts in by_path.items() if "dv1" in path},
            "dv1_train": dv1_train,
        },
        {
            # the cell's bf16 operand path (fabric.precision=bf16-mixed): the same source, the product on
            # wgmma.m64nNk16.f32.bf16.bf16; launches are the bf16 runs' (P2E-DV3's L DIAMBRA presets)
            "name": "hafner_cell_bf16",
            "route": "cuda",
            "source": "sheeprl_tpu_torch/kernels/csrc/hafner_gru.cu",
            "replaces": "sheeprl_tpu/kernels/pallas_tpu.py:67",
            "launches": sum(by_path[f"run_{family}_{phase}"]["hafner_cell"] for family, spec in RUN_P2E_SPECS.items()
                            if spec.get("bf16") for phase in ("exploration", "finetuning")),
            "max_abs_err": max(r["max_abs_err"] for rows in bf16_rows.values() for r in rows),
            "ms": bf16_row["ms"],
            "plain_ms": bf16_row["plain_ms"],
            "bound_ms": bf16_row["bound_ms"],
            "bound_by": bf16_row["bound_by"],
            "library_ms": bf16_row["cublas_product_ms"],
            "library": "cuBLAS GEMM of the product [h|x].W alone on bf16 operands (torch.matmul)",
            "product_ms": bf16_row["product_ms"],
            "gates_ms": bf16_row["gates_ms"],
            "variant": bf16_row["variant"]["product"],
            "shape": "B=1024 H=1024 X=768 (P2E-DV3 L finetuning's imagination)",
            "bf16_shapes": {
                name: [{k: r[k] for k in ("B", "H", "X", "ms", "plain_ms", "bound_ms", "bound_by", "cublas_product_ms",
                                          "max_abs_err", "grad_rel_err")}
                       | {"variant": r["variant"]["product"], "product_ms": r.get("product_ms"),
                          "gates_ms": r.get("gates_ms"), "vjp": r.get("vjp")}
                       for r in rows]
                for name, rows in bf16_rows.items()
            },
            "train_p2e_dv3_L_bf16": p2e_train["p2e_dv3_L_bf16"],
        },
        {
            "name": "hafner_sequence",
            "route": "cuda",
            "source": "sheeprl_tpu_torch/kernels/csrc/hafner_gru.cu",
            "replaces": "sheeprl_tpu/kernels/pallas_tpu.py:79",
            "launches": by_path["bench_kernels"]["hafner_sequence"],
            "max_abs_err": max(r["max_abs_err"] for r in seq_rows),
            "ms": seq_row["ms"],
            "plain_ms": seq_row["plain_ms"],
            "bound_ms": seq_row["bound_ms"],
            "bound_by": seq_row["bound_by"],
            "library_ms": None,
            "bound_f32_simt_ms": seq_row["bound_f32_simt_ms"],
            "variant": seq_row["variant"],
            "device_launches_per_call": seq_row["device_launches_per_call"],
            "projection_ms": seq_row["projection_ms"],
            "recurrence_ms": seq_row["recurrence_ms"],
            "sync_floor_us_per_step": seq_row.get("sync_floor_us_per_step"),
            "ms_by_variant": {v: r["ms"] for v, r in seq_row["variants"].items()},
            "device_launches_by_variant": {v: r["device_launches_per_call"] for v, r in seq_row["variants"].items()},
            "bench_fwd_bwd_s": bench_line["seconds_per_call"],
            "shape": "T=50 B=16 H=600 X=400 (kernel bench)",
            "launches_by_path": {path: counts["hafner_sequence"] for path, counts in by_path.items()},
        },
    ]
    print("[timing] " + json.dumps(clock.line()), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def _f64_cell(h, x, kernel, bias, ln_scale, ln_bias, *, eps):
    """The LayerNorm-GRU cell computed in f64 (product, LayerNorm and gates),
    its output rounded once to f32: the reference that the plain f32 cell and
    the kernel both round against."""
    import torch

    from sheeprl_tpu_torch.kernels import reference

    h64 = h.double()
    z = torch.cat([h64, x.double()], dim=-1) @ kernel.double()
    if bias is not None:
        z = z + bias.double()
    if ln_scale is not None:
        mu = z.mean(dim=-1, keepdim=True)
        var = (z - mu).square().mean(dim=-1, keepdim=True)
        z = (z - mu) * (var + eps).rsqrt() * ln_scale.double() + ln_bias.double()
    return reference.hafner_gates(z, h64).float()


TRAIN_GAP_SEEDS = (0, 1, 2)


def train_gap_readings(card: str, algos=("dreamer_v3_L", "dreamer_v3_XL")) -> dict:
    """The readings behind the L and XL train steps' limits (``python3
    chip_smoke.py --train-gaps``): at each of TRAIN_GAP_SEEDS (weights and
    noise), the kernel step and the plain-cell step of ``phase_train_dv3``'s
    comparison and a third with the cell computed in f64 (``_f64_cell``),
    TF32 off, the kernel path's discrete choices pinned. For each metric the
    relative gaps kernel against plain f32, plain f32 against the f64 cell
    and kernel against the f64 cell; the phase's gaps and limits
    (``_train_step_gaps``), and the metrics outside them."""
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for algo in algos:
            rows = []
            for seed in TRAIN_GAP_SEEDS:
                (kernel_m, _), (plain_m, _), pinned = _train_steps_kernel_and_plain(algo, seed, f64_cell=True)
                f64_m = pinned.pop("f64_cell")
                gaps, limits = _train_step_gaps(kernel_m, plain_m, algo)

                def rel(a, b):
                    return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for k in b}

                rows.append({"seed": seed, "kernel": kernel_m, "plain": plain_m, "f64_cell": f64_m,
                             "kernel_vs_plain": rel(kernel_m, plain_m), "plain_vs_f64_cell": rel(plain_m, f64_m),
                             "kernel_vs_f64_cell": rel(kernel_m, f64_m), "gaps": gaps, "limits": limits,
                             "outside": [k for k, g in gaps.items() if g > limits[k]], "pinned": pinned})
            out[algo] = {"K": int(_trainer_width(algo)), "seeds": rows}
            print(f"[train_gaps] {algo} " + json.dumps(out[algo]), flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    out["card"] = card
    return out


def main_train_gaps() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sheeprl_tpu_torch.kernels import build

    card = card_line()
    print(f"[card] {card}", flush=True)
    build.build_all()
    readings = train_gap_readings(card)
    print("[train_gaps] outside their limits: " + json.dumps(
        {algo: {row["seed"]: row["outside"] for row in readings[algo]["seeds"]} for algo in readings if algo != "card"}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main_train_gaps() if sys.argv[1:] == ["--train-gaps"] else main())
