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
   profiled window of PROFILED_STEPS more steps (every trainer below too);
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
  (``exp=dreamer_v3_100k_ms_pacman`` on ``discrete_dummy``: 1056 policy
  steps, learning from the preset's 1024, 32 acting steps, 33 gradient
  steps, a 5-step test episode that samples its actions), the same checks
  as phase 7 with the sequential buffer restored equal from the
  checkpoint, and 32 + 79 x 33 + 5 cell launches.

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
  replay at the same injected noise; 32 + 79 x 17 + 1000 cell launches.

Evaluation, registration and serving, eval_serve (after run_walker,
on run_dv3's and run_walker's checkpoints; the dv3 kernel rows gain B=10,
the eval pool's batch, and B=64, a full serving batch):

- ``cli.evaluation`` of each checkpoint at ``eval.episodes=10``: eval.json
  with the JAX package's keys, one registry line, one cell launch a pool
  step, and every pool step's actions against a plain-cell evaluation at
  the same seeds (equal; the walker's within TOL_CONTINUOUS_ACTION);
- ``cli.registration`` of the DV3 checkpoint, the cold start of
  ``ServeGateway.from_checkpoint("registry:best:dreamer_v3:<env>")`` (that
  gateway then runs the SLO fault drill: ``inject_dispatch_delay_s`` against
  a tight p99 bound fires the fast burn, dumps ``flight_slo_burn_*.json``,
  ``serve_report`` exits 1), and ``rescore_through_gateway`` of that ref:
  returns, lengths and every step's actions bit for bit the evaluation's,
  one cell launch a batch;
- the ``serve`` command in a subprocess with every ops knob on
  (SERVE_OPS_ARGS), its ring driven by SERVE_CLIENTS spawned clients
  (``serve/loadgen.py``); once all have had an answer, a publication of
  perturbed weights into the watched ``poll_root`` mid-load, one
  ``/metrics`` scrape (both versions' requests), the clients stopped, then
  SIGTERM: no failed request, versions monotone for every client, at least
  one swap, ``drained=clean`` and exit 0, one cell launch a batch;
  ``serve_live.json``'s requests equal to the clients' records, the access
  log's and the traces' sampled counts, every objective a verdict in
  ``serve_report --json``; requests/s, latency p50/p99,
  publication-to-new-version and drain time, and the ``[serve_ops]`` line:
  the traced stages' p50/p99 and each client's first answer split by stage
  (its process's start, then the six traced stages). ``--serve-ops`` runs
  the command with the ops off and on in turns, for their cost;
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
(recurrent 1024, dense 768 x 4, CNN multiplier 48, grey frames, 16 envs). The
card has no simulator: every one of these presets runs through its own
``env.wrapper``, the port's DIAMBRA or Crafter wrapper, over the stand-in
simulators of ``tests/sim_stubs.py`` (32-step episodes; a stand-in raises on
an action outside its action space):

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
- run_p2e_dv3_L_bf16 (after the P2E runs) and run_dv3_L, run_dv3_XL (after
  run_dv1): the presets through the CLI at full width, 9 gradient steps
  each, the same checks as the runs before them, and every floating array
  of each checkpoint's agent f32 (``_f32_parameters``). run_dv3_L's phase
  also runs (``phase_run_dv3_L``) the L Navigate preset
  (``exp=dreamer_v3_L_navigate``, RUN_NAVIGATE_ARGS) through the port's
  MineRL wrapper and CustomNavigate over the minerl stand-in, checked as the
  others (its buffer holding the preset's keys), and DreamerV3 on MineDojo
  (``phase_run_minedojo``: ``exp=dreamer_v3 env=minedojo`` at the default
  widths, RUN_MINEDOJO_ARGS, every acting step sampling through the env's
  masks, no action its masks forbid, launches as predicted, finite
  losses; then ``_minedojo_player_lockstep``: the captured masked acting
  step on the card against the CPU's step on 64 steps of 4 envs, every
  action equal, the state within TOL_STATE).

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
- run_p2e_dv1 (after the other P2E runs) and run_dv1 (in the ``runs`` lane):
  ``cli.run`` of RUN_P2E_SPECS["p2e_dv1"] (exploration, then finetuning with
  the actor switch) and of RUN_DV1_ARGS, checked as the runs before them
  (counters, graphs, event tags, deep-validated f32 checkpoints, DV1's
  sequential buffer restored equal), the evaluation command on the
  finetuning checkpoint, and the served actions of both checkpoints held
  against their evaluation policy's on the same frames and noise
  (``eval_policy_lockstep``).

The SAC family (SAC, DroQ, SAC-AE) and SAC on the port's device Pendulum
follow: their trainers after the DreamerV1 trainers, their runs in the
``runs`` lane (``--sac`` runs them alone). Then the on-policy
family, PPO, A2C and PPO-recurrent, at their presets' widths; no TPU kernel
is on their path (flax Dense, LayerNorm, Conv and ``nn.OptimizedLSTMCell``),
so every one of their paths must launch ``hafner_cell`` and
``hafner_sequence`` 0 times (``ppo_paths``):

- train_ppo, train_a2c, train_ppo_recurrent: one update of each preset's
  shape (PPO on its Nature-CNN pixel path) on the card against the port's
  own CPU update in float32 or float64 (one epoch at lr 0, TF32 off; losses
  within TOL_TRAIN_LOSS, the gradients' norm within TOL_TRAIN_GRAD),
  updates graphed against eager bit for bit with ``cudnn.deterministic``,
  then timed updates and minibatch steps, one profiled, and the peak
  memory (``phase_train_onpolicy``);
- run_ppo_cartpole, run_a2c_cartpole, run_ppo_recurrent_cartpole: the JAX
  learning tests' configs through the CLI on ``cartpole_stand_in`` (the
  card has no gymnasium), each passing its test's criterion, checkpointed,
  evaluated and served (served actions equal to the evaluation policy's),
  a window of updates traced (``phase_run_onpolicy``). ``--ppo`` runs these
  phases alone; ``--seeds <run> <seed> ...`` runs one of them at other seeds.

Then the decoupled SAC and PPO on the actor–learner plane, in the ``plane``
lane (``--decoupled``
runs them alone): the learner on the card, the players on the CPU in a
thread or in processes with their envs on the shared-memory worker pool; no
TPU kernel is on their path, so every run launches both kernels 0 times
(``decoupled_paths``); while a process run is live, no player or env
worker holds one of the card's device files open and the learner does
(``_PlaneWatch``), and every player reports at its exit that it
initialised no CUDA:

- run_sac_decoupled: ``exp=sac_decoupled fabric.devices=auto`` on
  ``pendulum_stand_in`` at test_sac_learns_pendulum's settings: a thread
  run and a 1-player process run (DECOUPLED_SAC_CUT_STEPS) bitwise equal in
  their final learner state and replay; a 2-player run on two shards with TD
  priorities at the same length, every sampled row's priority written back;
  a 2-player run on two shards at the test's length passing its criterion,
  evaluated and served (``phase_run_sac_decoupled``);
- run_ppo_decoupled: ``exp=ppo_decoupled`` on ``cartpole_stand_in`` at
  test_ppo_learns_cartpole's config on two player processes of 4 envs,
  passing its criterion, evaluated and served (``phase_run_ppo_decoupled``).
  ``--seeds run_sac_decoupled <seed> ...`` (and ``run_sac_decoupled_td``)
  runs the SAC learning run at other seeds.

The run telemetry (``metric=telemetry``, TELEMETRY_ARGS) is on in three of
those runs, and each is held to its own counts: run_dv3 (its ``hafner_cell``
launches as predicted; ``recompiles`` and ``graph_replays`` equal to its
graphs' captures and replays; ``peak_hbm_bytes`` equal to
``torch.cuda.max_memory_allocated``; ``Perf/mfu`` logged between 0 and 100;
the env, train and checkpoint phases' percentiles; no flight dump; its trace
merged by ``sheeprl_tpu_torch/tools/trace_view.py``), run_sac_decoupled's 1-player run (still
bitwise the thread run; the slabs and versions the players' snapshots fold
in equal to the loop's) and its 2-player run (the staleness section, both
players' watchdog beats, ``plane.keep_policies`` versions in
``<log_dir>/policy/``, the learner's blocked seconds in ``publish``). The
``[telemetry]`` line gives their policy steps/s beside PR 15's with the
telemetry off, and the seconds the checks took.

Profiling and learning health (PR 17, ``obs/prof``, ``obs/learn``) ride
existing phases. run_dv3 runs with the learn probes on and one scheduled
profiler window (RUN_DV3_TELEMETRY_ARGS: a log every 8 policy steps, the
window from the boundary at 1048 to the last, so the run is not traced
whole): one capture, none
failed; the window's ``hafner_gates_kernel`` runs (the trace parser's
count) equal to the ``hafner_cell`` counter's delta over the window;
``device_ms_per_step`` (the parser's, over the train graph's replays)
within TOL_PROF_DEVICE_MS of CUDA events around the same replays; a
roofline verdict; the ``learn/*`` probes and no critical event
(``[run_dv3_capture]``, the run line's ``telemetry.prof``); a window on the
card with no device event is a failed capture, never host time. train_dv3
holds one graphed DV3 step's learn probes against the CPU step's from the
same state, at the preset's learning rates (``update_ratio`` included) and
at 0, within TOL_TRAIN_LOSS, the gradient norms downstream of the world
model's update within TOL_TRAIN_GRAD (``[train_dv3_probes]``).
run_ppo_cartpole adds one update
traced whole by ``metric.profiler=<dir>``, whose trace must hold CUDA kernel
events (``[run_ppo_cartpole_profiler]``). run_sac_decoupled's 2-player run
opens the flight recorder's profiler window at its dump, which must parse
with device events and the train step (its ``flight_windows``).

Data-parallel training (ROADMAP queue A item 7a) runs in two phases,
one in each lane, on the one card: ``ddp_nccl`` spawns a world of one NCCL
rank (``parallel.spawn``) whose DreamerV3 (100k width), DreamerV2
(MsPacman width) and PPO (Nature-CNN) steps capture their all-reduces in
the steps' graphs, each held bit for bit against the same graphed steps
outside a world (``cudnn.deterministic``), one more DreamerV3 replay
profiled (its NCCL kernels and the trace parser's ``comms_ms_total`` above
0: in a world of one rank NCCL's average is one ``oneRankReduce`` kernel a
bucket, where an in-place sum would be no work and a gather a device copy),
and ``fabric.devices=2`` through the CLI must
raise on the one card; ``ddp_gloo`` spawns two gloo ranks sharing the card
(their train steps eager: gloo's collectives run on the host) for
DDP_GLOO_STEPS DreamerV3 steps at the 100k width, each rank on its own
batch and noise (the reward and critic heads moved off their zero init
from a seed, ``_live_heads``), the ranks' states bitwise equal after every
step, the cell's launches a rank the prediction, and the first step's metrics held
against the same two ranks on the CPU within TOL_TRAIN_LOSS and
TOL_TRAIN_GRAD, the card's ranks taking the CPU ranks' straight-through
samples' choices (``_PinnedSamples``: a near-tie flipped by rounding is
counted, not followed) (``[ddp_nccl]``, ``[ddp_gloo]`` lines; the ranks'
launches join ``ddp_paths``).

Each path's launch counts are zeroed just before its run and read just
after it: the served run (phase 4), the bench (phase 5), the timed train
steps (phases 6, train_dv3, train_walker) and the graphed steps
(train_dv2_continuous), the training runs (phases 7, run_dv3 and
run_walker), and eval_serve's evaluations, rescore, serve command and
in-run run (``launches_by_path``), and the P2E trainers, runs, evaluations and
serving, the DreamerV1 paths (``dv1_paths``, each 0), the SAC family's
(``sac_paths``), the on-policy family's (``ppo_paths``, both kernels, each 0) and the decoupled runs'
(``decoupled_paths``, both kernels, each 0). The ``kernels``
line's cell ``launches`` is the f32 training runs' sum (the seven Dreamer runs, the MineDojo run and its masked
acting steps, and the six f32 P2E runs, DV1's at 0; the bf16 P2E runs' are ``hafner_cell_bf16``'s); its ``p2e_shapes`` and
``p2e_train`` keys carry the P2E rows. The build phase also counts the tensor-core instructions
(``HGMMA``, ``HMMA``) in the built library's SASS (``cuobjdump -sass``).

The order on the card. The kernel phases, every trainer (the Dreamer
families', then the SAC and on-policy families') and run_dv3 have the card
alone. Then two more processes, the lanes (``chip_smoke.py --lane <name>
<out>``, LANES), run beside the main process's run, run_walker, eval_serve
and P2E runs: ``runs`` (run_dv1, run_dv3_L's phase, run_dv3_XL, the SAC
family's runs and run_sac_pendulum, run_ppo_cartpole, run_a2c_cartpole,
ddp_nccl) and ``plane`` (run_sac_decoupled, run_ppo_decoupled,
run_ppo_recurrent_cartpole, ddp_gloo). A lane's output is echoed when it ends, and
it fails the script if it fails. The ``[timing]`` line carries each lane's
own line under ``lanes``. On a failure the script kills every process it
started.

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
import gc
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
# timed steps of each trainer, eager and graphed; then PROFILED_STEPS more under the profiler (the device's busy time
# a step, which the idle share divides by the timed steps' wall time), cut from 4 to make room in the script's time
# for the real-simulator runs: ``python3 chip_smoke.py --train-steps`` reads each trainer at 2 and at 4 steps side by
# side (PERF.md section 6: the busy time a step agrees within the repeats' spread or 3.6 %)
TRAIN_STEPS = 4
PROFILED_STEPS = 2
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
DV3_TRAIN_STEPS = TRAIN_STEPS
# the DV3 run: the port's CLI with exp=dreamer_v3_100k_ms_pacman at its full width (its sequential buffer checkpointed,
# log_level 1, learning from the preset's 1024, one gradient step a policy step) on the dummy env (1 head of 2
# actions, 5-step episodes); cut: a buffer of 4096 steps, 1056 policy steps (33 gradient steps: the pretrain step at
# 1024 and one a step after it), a log every 256 policy steps
RUN_DV3_ARGS = (
    "exp=dreamer_v3_100k_ms_pacman", "env=dummy", "env.id=discrete_dummy", "env.sync_env=True", "buffer.size=4096",
    "total_steps=1056", "metric.log_every=256",
)
RUN_DV3_UPDATES, RUN_DV3_PLAYER_STEPS, RUN_DV3_GRADIENT_STEPS, RUN_DV3_TEST_STEPS = 1056, 32, 33, 5
# the run telemetry (metric=telemetry) inside runs the script makes anyway: run_dv3, and run_sac_decoupled's 1-player
# process run and its 2-player run at the test's length (those two with the learn probes off: the 1-player run is held
# bitwise to the thread run)
TELEMETRY_ARGS = ("metric=telemetry", "metric.telemetry.learn.enabled=False")
# run_dv3's: the learn probes on (the shipped default), and one scheduled profiler window, from the log boundary at
# policy step 1048 to the next (1056, the run's last; no deadline: the steps' host time varies by host), which a log
# every 8 policy steps makes: the train graph's last 8 replays (~16k kernels each; its eager warm-ups and capture at
# 1025-1027 stay out) and the acting steps between them. A window's cost grows with its events (stopping the session,
# reading, writing and parsing them): all 32 train steps, ~580k events, cost ~34 s of host time on the card's host
RUN_DV3_TELEMETRY_ARGS = ("metric=telemetry", "metric.log_every=8", "metric.telemetry.profile.every_n_steps=1048",
                          "metric.telemetry.profile.window_s=0", "metric.telemetry.profile.max_captures=2")
# the window's device time a train step (the parser's, over the graph's replays) against CUDA events around the same
# replays, relative: the events also hold each replay's graph launch (~20 us on an idle stream)
TOL_PROF_DEVICE_MS = 0.05
# those runs' policy steps/s with the telemetry off, PR 15 (PERF.md §6: the 2-player run from call 18, the 1-player run
# from call 5; no rate of run_dv3 was kept)
PR15_TELEMETRY_OFF_POLICY_STEPS_PER_S = {"run_dv3": None, "run_sac_decoupled_one_player": 103.0,
                                         "run_sac_decoupled_two_players": 580.0}
# each telemetry run's checks, filled by its phase: printed as the [telemetry] line
TELEMETRY_CHECKS = {}
# the walker: the DV3 DMC walker_walk preset at its full width (rgb and a 24-wide state, 6 continuous actions)
WALKER_OBS = {"rgb": (3, 64, 64), "state": (24,)}
WALKER_ACTIONS = 6
# the walker run: the port's CLI with exp=dreamer_v3_dmc_walker_walk at its full width (1 env, train_every 2, the memmap
# sequential buffer checkpointed, log_level 1) on walker_stand_in; cut: a buffer of 4096 steps in place of 1e5, learning
# from 1024 in place of 8000, 1056 policy steps (17 gradient steps: the pretrain step at 1024 and one every 2 after
# it), a log every 256 policy steps; the envs stepped in the process (sync) and no video
# capture (not ported)
RUN_WALKER_ARGS = (
    "exp=dreamer_v3_dmc_walker_walk", "env.wrapper._target_=chip_smoke.walker_stand_in", "env.sync_env=True",
    "env.capture_video=False", "buffer.size=4096", "algo.learning_starts=1024", "total_steps=1056",
    "metric.log_every=256",
)
RUN_WALKER_UPDATES, RUN_WALKER_PLAYER_STEPS, RUN_WALKER_GRADIENT_STEPS, RUN_WALKER_TEST_STEPS = 1056, 32, 17, 1000
RUN_WALKER_LOG_STEPS = (256, 512, 768, 1024, 1056)
# DIAMBRA's Dead or Alive++ (the combo-discrete action: 9 moves + 8 attack-button combinations - 1 shared no-op) and
# Crafter: their action counts, as the stand-in simulators of tests/sim_stubs.py give them
DOAPP_ACTIONS = 16
CRAFTER_ACTIONS = 17
# a stand-in simulator's episodes end after this many steps (a round, a Crafter life; tests/sim_stubs.py
# EPISODE_STEPS): the runs' test episodes stay short
STAND_IN_EPISODE = 32
# the L and XL runs: the port's CLI with exp=dreamer_v3_L_doapp (8 envs, train_every 8) and exp=dreamer_v3_XL_crafter
# (1 env, train_every 2) at full width in f32 through the port's DIAMBRA and Crafter wrappers (the presets' own
# env.wrapper) over the stand-in simulators of tests/sim_stubs.py (the card has neither simulator; the stand-ins give
# DIAMBRA's and Crafter's raw spaces, 32-step episodes, and raise on an action outside the action space), the
# sequential buffer checkpointed, log_level 1. Cuts: a buffer of 4096
# steps (5e6 and 1e6), learning from 1024 and 128 policy steps (65536 and 1024: 128 steps an env, two sequences of
# 64), 1088 and 144 policy steps (5e6 and 1e6): 9 gradient steps each (the pretrain step and 8), a log every 256 and
# 64 policy steps. The XL preset's env.id is "reward", which no Crafter wrapper takes (the JAX one raises on it too):
# the run names its task, crafter_reward
RUN_L_ARGS = (
    "exp=dreamer_v3_L_doapp", "env.sync_env=True", "env.capture_video=False", "buffer.size=4096",
    "algo.learning_starts=1024", "total_steps=1088", "metric.log_every=256",
)
RUN_XL_ARGS = (
    "exp=dreamer_v3_XL_crafter", "env.id=crafter_reward", "env.sync_env=True", "env.capture_video=False",
    "buffer.size=4096", "algo.learning_starts=128", "total_steps=144", "metric.log_every=64",
)
# the L Navigate run (inside run_dv3_L's phase): exp=dreamer_v3_L_navigate at full L width in f32 (recurrent 2048,
# dense 768 x 4, CNN multiplier 64; 4 envs, train_every 16, multihot_inventory off) through the port's MineRL wrapper
# and CustomNavigate over the minerl stand-in, the sequential buffer checkpointed, log_level 1. Cuts, as run_dv3_L's:
# a buffer of 4096 steps (5e6), learning from 512 policy steps (65536: 128 steps an env, two sequences of 64), 640
# policy steps (5e7): 9 gradient steps (the pretrain step at update 128 and one every 4 updates after it), a log
# every 128 policy steps
RUN_NAVIGATE_ARGS = (
    "exp=dreamer_v3_L_navigate", "env.sync_env=True", "env.capture_video=False", "buffer.size=4096",
    "algo.learning_starts=512", "total_steps=640", "metric.log_every=128",
)
NAVIGATE_OBS = {"rgb": (3, 64, 64), "life_stats": (3,), "inventory": (1,), "max_inventory": (1,), "compass": (1,),
                "reward": (1,)}
NAVIGATE_ACTIONS = 14  # the no-op, attack, back, 4 camera moves, forward, jump, left, place dirt, right, sneak, sprint
# the MineDojo run (inside run_dv3_L's phase): exp=dreamer_v3 env=minedojo at DreamerV3's default widths (recurrent
# 256, dense 512 x 2, CNN multiplier 32; rgb and the inventory, equipment and life-stats vectors; actions 19 x 16 x 60)
# through the port's MineDojo wrapper over the minedojo stand-in, whose masks the acting step samples through (as
# JAX's: by the wrapper's _target_). The stand-in flags, without raising, every action its masks forbid; the run must
# send none. Cuts: 2 envs, 320 policy steps, training every 160 policy steps for 2 gradient steps (the first at 80
# rows an env), a buffer of 4096 steps, a log every 160 policy steps; learning from 0 and no test episode: the wrapper
# (sheeprl_tpu/envs/minedojo.py:218, as upstream SheepRL's) raises KeyError on an equip, place or destroy of an item
# the inventory does not hold, which the preset's random prefill and the unmasked test episode (the JAX loop passes
# the masks to its acting steps only) draw, and the env's restart wrapper gives up after its third crash
RUN_MINEDOJO_ARGS = (
    "exp=dreamer_v3", "env=minedojo", "env.num_envs=2", "env.sync_env=True", "env.capture_video=False",
    "mlp_keys.encoder=[inventory,inventory_max,inventory_delta,equipment,life_stats]", "algo.learning_starts=0",
    "algo.train_every=160", "algo.per_rank_gradient_steps=2", "algo.run_test=False", "buffer.size=4096",
    "total_steps=320", "metric.log_every=160",
)
RUN_MINEDOJO_COUNTS = (160, 160, 4, 0)  # (updates, player steps, gradient steps, test steps)
# the masked acting step on the card (its CUDA graph, the masks among its inputs) against the same step on the CPU
# (the plain cell), from the card's state before each step, at noise drawn on the host: MINEDOJO_PLAYER_STEPS steps of
# MINEDOJO_PLAYER_ENVS envs stepped with the card's actions at exploration MINEDOJO_PLAYER_EXPL (the preset's is 0:
# this runs the masked redraws too); every head's action equal, the state within TOL_STATE
MINEDOJO_PLAYER_STEPS, MINEDOJO_PLAYER_ENVS, MINEDOJO_PLAYER_EXPL = 64, 4, 0.3
MINEDOJO_PATHS = ("run_dv3_minedojo", "dv3_minedojo_player")
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
P2E_TRAIN_STEPS = TRAIN_STEPS
# the P2E runs: the port's CLI at each preset's full width on the discrete dummy env (2 actions, 5-step episodes), 4
# envs, the sequential buffer, log_level 1; exploration, then finetuning from its checkpoint, the finetuning player
# acting with the exploration actor until learning_starts and with the task actor after it, inside the run. Cuts:
# a buffer of 4096 steps (1e6 and 5e6), 1024 and 512 policy steps (P2E-DV3; 5e6 and 1e6) and 384 and 256
# (P2E-DV2),
# learning from 512 and 320 (P2E-DV3; 65536 both) and 256 and 224 (P2E-DV2; 1000 both), a log every 256 (5000);
# P2E-DV2's pretraining burst at learning_starts 10 gradient steps (100)
P2E_ENV_ARGS = ("env=dummy", "env.id=discrete_dummy", "env.sync_env=True", "buffer.size=4096", "metric.log_every=256")
P2E_L_ENV_ARGS = ("env.sync_env=True", "env.capture_video=False", "buffer.size=4096", "metric.log_every=256")
RUN_P2E_SPECS = {
    "p2e_dv3": dict(
        exploration=("exp=p2e_dv3_exploration", "total_steps=1024", "algo.learning_starts=512") + P2E_ENV_ARGS,
        finetuning=("exp=p2e_dv3_finetuning", "total_steps=512", "algo.learning_starts=320") + P2E_ENV_ARGS,
        # (updates, random, player steps by actor, gradient steps, test steps, the update of the switch)
        exploration_counts=(256, 128, [128], 33, 5, None),
        finetuning_counts=(128, 0, [79, 49], 13, 5, 80),
    ),
    "p2e_dv2": dict(
        exploration=("exp=p2e_dv2_exploration", "total_steps=384", "algo.learning_starts=256",
                     "algo.per_rank_pretrain_steps=10") + P2E_ENV_ARGS,
        finetuning=("exp=p2e_dv2_finetuning", "total_steps=256", "algo.learning_starts=224",
                    "algo.per_rank_pretrain_steps=10") + P2E_ENV_ARGS,
        exploration_counts=(96, 64, [32], 42, 5, None),
        finetuning_counts=(64, 0, [55, 9], 18, 5, 56),
    ),
    # P2E-DV3's L DIAMBRA presets under their bf16-mixed through the port's DIAMBRA wrapper over the diambra stand-in
    # (grey frames, the reward as an observation,
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
        obs=DOAPP_P2E_OBS, actions=DOAPP_ACTIONS, bf16=True, algo="p2e_dv3", simulators=("diambra",),
    ),
}
# DreamerV1 and P2E-DV1: their recurrent core is flax's GRU cell, PyTorch operations on the card as in the
# JAX package (no Pallas kernel there, so none here), and every DV1 path must launch hafner_cell 0 times
DV1_TRAIN_STEPS = TRAIN_STEPS
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


@contextlib.contextmanager
def _gc_paused():
    """Around ``device_ms``'s capture: the collector off until it ends (a
    CUDA graph in a garbage cycle finalized in the middle of a capture
    invalidates it: ``train/graphs.capture_guard``), without the full
    collection ``capture_guard`` makes first, ~0.2 s a call in this process
    and hundreds of calls a run: ``device_ms``'s own graphs go by their
    reference counts."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


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
    graph = torch.cuda.CUDAGraph()
    with _gc_paused(), torch.cuda.graph(graph):
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
    result = bench_dreamer.compare(steps=TRAIN_STEPS, device="cuda", profile=True, profiled_steps=PROFILED_STEPS)
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


def _state_tensors(tree) -> list:
    """Every tensor a train step updates in an agent state: the modules'
    parameters and buffers, the optimizers' per-parameter state, device
    scalars (the moments), through nested dicts and lists."""
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, torch.optim.Optimizer):
        return [t for entry in tree.state.values() for t in entry.values() if isinstance(t, torch.Tensor)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _state_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _state_tensors(v)]
    return []


def _dv3_probes_card_against_cpu() -> dict:
    """The learn probes (``obs/learn``) of one DreamerV3 step at the 100k
    preset's width (the batch cut to 2 x 8): the CPU's eager call against
    the card's graph replay, each from the same initial state, twice: at
    the preset's learning rates (so the optimizers' ‖lr·u‖², taken inside
    the captured graph, is held: ``update_ratio``) and with every learning
    rate 0 (nothing moves within the step). The card runs WARMUP_CALLS
    eager calls and the capture's replay, then puts back the state it
    started from (in place: the graph reads those tensors) before each
    compared replay; the CPU puts it back before its second call; the
    learning rates are device scalars the graph reads (``set_lr``). The
    same seeded noise in every call. Each probe's relative gap against
    TOL_TRAIN_LOSS, but at the preset's rates the actor's and the critic's
    gradient norms against TOL_TRAIN_GRAD (the script's card-against-CPU
    limit for gradient norms): their inputs carry the world model's update
    of the same step. At 1 x 4 the actor's gradient norm, ~3.8e-4 against
    the world model's ~5.5e3, reads 3.4e-7 apart (8.9e-4 relative): not
    held there."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as train
    from sheeprl_tpu_torch.obs import learn
    from sheeprl_tpu_torch.tools import bench_dreamer
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS
    from sheeprl_tpu_torch.utils.optim import set_lr

    overrides = {"per_rank_batch_size": 2, "per_rank_sequence_length": 8}
    probes, noise = {}, None
    learn.install(learn.LearnSentinel())
    try:
        for device in ("cpu", "cuda"):
            cfg, state, program, data = bench_dreamer.build_trainer(device, seed=0, algo="dreamer_v3", **overrides)
            T, B = data["rewards"].shape[:2]
            if noise is None:
                noise = train.draw_noise(cfg, (9,), T, B, torch.Generator().manual_seed(SEED), "cpu", False)
            moved = {k: [t.to(device) for t in v] if isinstance(v, list) else v.to(device) for k, v in noise.items()}
            stack = {k: v[None] for k, v in data.items()}
            tensors = _state_tensors(state)
            start = [t.detach().clone() for t in tensors]

            def restore():
                with torch.no_grad():
                    for t, t0 in zip(tensors, start):
                        t.copy_(t0)

            def call():
                if device == "cuda":
                    program.burst(state, stack, [0.0], noise=[moved])
                else:
                    program(state, data, noise=moved)
                return {k: float(v) for k, v in program.learn_tap.last().items()}

            if device == "cuda":
                for _ in range(WARMUP_CALLS + 1):
                    call()
                restore()
            probes[device, "lr"] = call()
            restore()
            for opt in state["opt"].values():
                set_lr(opt, 0.0)
            probes[device, "lr0"] = call()
            replays = program.step.replays if device == "cuda" else 0
            del state, program, data, start, tensors
    finally:
        learn.install(None)
    torch.cuda.empty_cache()
    line, bad = {"card_replays": replays, "overrides": overrides}, []
    for rates in ("lr", "lr0"):
        card, cpu = probes["cuda", rates], probes["cpu", rates]
        gaps = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-6) for k in cpu}
        limits = {k: TOL_TRAIN_GRAD if rates == "lr" and k in ("learn/grad_norm/actor", "learn/grad_norm/critic")
                  else TOL_TRAIN_LOSS for k in cpu}
        line[rates] = {"card": card, "cpu": cpu, "rel_diff": gaps, "limits": limits}
        bad += [f"{rates} {k}" for k in cpu if gaps[k] > limits[k]]
        if sorted(card) != sorted(cpu):
            bad.append(f"{rates} keys")
    if replays != 3 or not probes["cpu", "lr"].get("learn/update_ratio") or probes["cpu", "lr0"]["learn/update_ratio"]:
        bad.append("replays or update ratios")
    if bad:
        raise AssertionError(f"train_dv3: the graphed step's learn probes against the CPU's: {bad} {line}")
    return line


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
    if algo == "dreamer_v3":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            print(f"[{tag}_probes] " + json.dumps(_dv3_probes_card_against_cpu()), flush=True)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]

    result = bench_dreamer.compare(steps=DV3_TRAIN_STEPS, device="cuda", profile=True, algo=algo, profiled_steps=PROFILED_STEPS)
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

    result = bench_dreamer.compare(steps=P2E_TRAIN_STEPS, device="cuda", profile=True, algo=algo, profiled_steps=PROFILED_STEPS)
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

    result = bench_dreamer.compare(steps=DV1_TRAIN_STEPS, device="cuda", profile=True, algo=algo, profiled_steps=PROFILED_STEPS)
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
    ``names``. Read by the port's trace parser from the profiler's raw
    events (``obs/prof/trace.py``): building its function events and
    averages takes minutes on a run of 10^5-10^6 kernels."""
    from sheeprl_tpu_torch.obs.prof.trace import device_durations

    device = device_durations(prof)
    return sum(us for _name, us in device), {n: sum(n in name for name, _us in device) for n in names}


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


def _read_verified(ckpt) -> dict:
    """A checkpoint's whole state, every crc32 verified (``ckpt`` a path), or
    a state the caller already read so."""
    from sheeprl_tpu_torch.ckpt import read_checkpoint

    return ckpt if isinstance(ckpt, dict) else read_checkpoint(ckpt, verify=True)


def _check_episode_buffer(ckpt) -> dict:
    """The checkpoint's episode buffer, every crc32 verified, restored into
    a fresh buffer whose ``state_dict`` equals the one read back."""
    import numpy as np

    from sheeprl_tpu_torch.data.buffers import EpisodeBuffer

    opts = dict(a.split("=", 1) for a in RUN_ARGS)
    n_envs = int(opts["env.num_envs"])
    rb_state = _read_verified(ckpt)["rb"]
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

    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer

    del args  # the envs and each one's size come from the checkpoint
    rb_state = _read_verified(ckpt)["rb"]
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
    computes in bf16 and keeps its parameters in f32 (``ckpt`` a path or a
    state read already). Returns the counts."""
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

    walk((ckpt if isinstance(ckpt, dict) else read_checkpoint(ckpt, with_rb=False))["agent"])
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
    "run_dv3": dict(args=RUN_DV3_ARGS + RUN_DV3_TELEMETRY_ARGS,
                    counts=(RUN_DV3_UPDATES, RUN_DV3_PLAYER_STEPS, RUN_DV3_GRADIENT_STEPS, RUN_DV3_TEST_STEPS),
                    per_step=DV3_CELL_LAUNCHES_PER_STEP, log_steps=tuple(range(8, 1057, 8)), learning_starts=1024,
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
                      obs=DOAPP_L_OBS, continuous=False, actions=DOAPP_ACTIONS, simulators=("diambra",)),
    "run_dv3_XL": dict(args=RUN_XL_ARGS, counts=(144, 16, 9, STAND_IN_EPISODE), per_step=DV3_CELL_LAUNCHES_PER_STEP,
                       log_steps=(64, 128, 144), learning_starts=128,
                       buffer=lambda ckpt: _check_sequential_buffer(ckpt, RUN_XL_ARGS, tuple(CRAFTER_OBS)),
                       obs=CRAFTER_OBS, continuous=False, actions=CRAFTER_ACTIONS, simulators=("crafter",)),
    # 160 updates of 4 envs, 128 random ones up to learning_starts, then 32 acting steps; the test episode is one
    # stand-in episode
    "run_dv3_L_navigate": dict(
        args=RUN_NAVIGATE_ARGS, counts=(160, 32, 9, STAND_IN_EPISODE), per_step=DV3_CELL_LAUNCHES_PER_STEP,
        log_steps=(128, 256, 384, 512, 640), learning_starts=512,
        buffer=lambda ckpt: _check_sequential_buffer(ckpt, RUN_NAVIGATE_ARGS, tuple(NAVIGATE_OBS)),
        buffer_keys=tuple(NAVIGATE_OBS), obs=NAVIGATE_OBS, continuous=False, actions=NAVIGATE_ACTIONS,
        simulators=("minerl",)),
    # (updates, player steps, gradient steps, test steps): 192 updates of 4 envs, 128 random ones up to learning_starts,
    # then 64 acting steps; 3 bursts of 8 (at updates 128, 160 and 192); a 5-step test episode; no cell kernel
    "run_dv1": dict(args=RUN_DV1_ARGS, counts=(192, 64, 24, 5), per_step=0, log_steps=(256, 512, 768),
                    learning_starts=512, buffer=_check_sequential_buffer, obs=OBS, continuous=False, cell=False),
}


def _telemetry_summary(log_dir: str) -> dict:
    with open(os.path.join(log_dir, "telemetry.json")) as f:
        return json.load(f)


def _trace_view(log_dir: str) -> dict:
    """The run's trace files merged by ``sheeprl_tpu_torch/tools/trace_view.py``
    into one Perfetto trace: the merged events by kind."""
    from sheeprl_tpu_torch.tools import trace_view

    merged = trace_view.merge(trace_view.discover([log_dir]))["traceEvents"]
    kinds = {}
    for e in merged:
        kinds[e.get("ph")] = kinds.get(e.get("ph"), 0) + 1
    if not kinds.get("X"):
        raise AssertionError(f"the merged trace of {log_dir} holds no span: {kinds}")
    return {"events_by_phase_kind": kinds, "pids": sorted({e.get("pid") for e in merged if e.get("ph") == "X"})}


def _check_run_telemetry(name: str, result, wall: float, graphs: dict, peak: int) -> dict:
    """A telemetry run's ``telemetry.json`` against the run's own counts: the
    CUDA-graph captures and replays of its steps (``recompiles``,
    ``graph_replays``), ``torch.cuda.max_memory_allocated`` read at the run's
    end (``peak_hbm_bytes``) and the card's memory (``hbm_bytes_limit``);
    ``Perf/mfu`` logged strictly between 0 and 100; the env, train and
    checkpoint phases' percentiles; no flight dump; the trace merged by
    ``sheeprl_tpu_torch/tools/trace_view.py``."""
    import glob

    import torch

    from sheeprl_tpu_torch.utils.tb_events import read_events

    t0 = time.perf_counter()
    log_dir = result["log_dir"]
    summary = _telemetry_summary(log_dir)
    counts = {"recompiles": sum(g["captured"] for g in graphs.values()),
              "graph_replays": sum(g["replays"] for g in graphs.values()),
              "peak_hbm_bytes": peak, "hbm_bytes_limit": torch.cuda.get_device_properties(0).total_memory}
    got = {k: summary[k] for k in counts}
    if got != counts:
        raise AssertionError(f"{name}: telemetry.json reads {got}, the run {counts}")
    mfu = [v.get("simple_value") for e in read_events(result["event_file"]) for v in e.get("values", [])
           if v.get("tag") == "Perf/mfu"]
    if not mfu or not all(v is not None and 0.0 < v < 100.0 for v in mfu):
        raise AssertionError(f"{name}: Perf/mfu logged as {mfu}")
    phases = summary["phase_percentiles"]
    want = ("Time/env_interaction_time", "Time/train_time", "Time/checkpoint_time")
    if not all(phases.get(k, {}).get("count") for k in want):
        raise AssertionError(f"{name}: phase_percentiles holds {sorted(phases)}")
    dumps = glob.glob(os.path.join(log_dir, "telemetry", "flight_*.json"))
    if dumps or summary["flight_dumps"]:
        raise AssertionError(f"{name}: the flight recorder fired: {dumps}")
    merged = _trace_view(log_dir)
    checks_s = time.perf_counter() - t0
    line = {**got, "mfu": summary["mfu"], "perf_mfu_logged": mfu, "flops_per_train_step": summary["flops_per_train_step"],
            "compile_secs": summary["compile_secs"], "phases": {k: phases[k] for k in want},
            "policy_steps_per_s": result["policy_steps"] / wall, "trace_view": merged, "checks_s": checks_s}
    TELEMETRY_CHECKS[name] = line
    return line


class _ReplayEvents:
    """Within the block, CUDA events around every replay of a train step's
    graph made while a profiler session records (``ms``: each replay's
    elapsed milliseconds, read at the block's end)."""

    def __enter__(self):
        import torch

        from sheeprl_tpu_torch.train.graphs import CapturedStep

        self.pairs, self._real = [], CapturedStep._call
        real, pairs = self._real, self.pairs

        def timed(step):
            if not (step.train and step.graph is not None and torch.autograd._profiler_enabled()):
                return real(step)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(step)
            end.record()
            pairs.append((start, end))
            return out

        CapturedStep._call = timed
        return self

    def __exit__(self, *exc):
        import torch

        from sheeprl_tpu_torch.train.graphs import CapturedStep

        CapturedStep._call = self._real
        torch.cuda.synchronize()
        self.ms = [s.elapsed_time(e) for s, e in self.pairs]
        return False


def _check_run_prof(name: str, result, replays: "_ReplayEvents") -> dict:
    """A run's scheduled profiler window (``obs/prof``) and its learn
    probes, against the run's own counts: one capture or more and none
    failed; the window's ``hafner_gates_kernel`` runs (the parser's count)
    equal to the ``hafner_cell`` launch counter's delta over the same
    window; ``device_ms_per_step`` (the parser's, over the train graph's
    replays) within TOL_PROF_DEVICE_MS of the mean of CUDA events around
    the same replays; a roofline verdict of the four; the train module
    attributed through ``cudaGraphLaunch`` (device events inside the
    replays); the ``learn/*`` keys, and no critical event on this healthy
    run."""
    import statistics

    t0 = time.perf_counter()
    summary = _telemetry_summary(result["log_dir"])
    prof = summary.get("prof") or {}
    if summary["prof_captures"] < 1 or prof.get("failed"):
        raise AssertionError(f"{name}: prof_captures {summary['prof_captures']}, failed {prof.get('failed')}")
    kernels = prof.get("kernel_counts") or {}
    gates = sum(n for k, n in kernels.items() if "hafner_gates_kernel" in k)
    products = sum(n for k, n in kernels.items() if "hafner_product_kernel" in k)
    launched = (prof.get("kernel_launches") or {}).get("hafner_cell")
    if not gates or gates != launched:
        raise AssertionError(f"{name}: the window holds {gates} hafner_gates_kernel runs, the counter's delta {launched}")
    device_ms = summary["device_ms_per_step"]
    event_ms = statistics.fmean(replays.ms) if replays.ms else None
    with open(os.path.join(result["log_dir"], "telemetry", "prof", f"capture_{prof['step']}.json")) as f:
        record = json.load(f)
    print(f"[{name}_capture] " + json.dumps({k: record.get(k) for k in (
        "step", "source", "train_module", "train_execs", "device_ms_per_step", "busy_frac", "window_ms", "modules",
        "kernel_launches", "roofline_verdict", "mfu_device_pct", "achieved_gbps")} | {"event_ms": replays.ms}),
          flush=True)
    if len(replays.ms) < 8 or device_ms is None or abs(device_ms - event_ms) > TOL_PROF_DEVICE_MS * event_ms:
        raise AssertionError(f"{name}: device_ms_per_step {device_ms} against {event_ms} ms from CUDA events over "
                             f"{len(replays.ms)} replays (tolerance {TOL_PROF_DEVICE_MS} relative)")
    if summary["roofline_verdict"] not in ("compute-bound", "memory-bound", "dispatch-bound", "unknown"):
        raise AssertionError(f"{name}: roofline_verdict {summary['roofline_verdict']}")
    if prof.get("source") != "device" or prof.get("train_module") != "train_step":
        raise AssertionError(f"{name}: the window's train module {prof.get('train_module')} from {prof.get('source')}")
    learn = summary.get("learn") or {}
    probes = sorted(learn.get("probes") or {})
    want = {"learn/grad_norm", "learn/param_norm", "learn/update_ratio", "learn/clip_frac"} | {
        f"learn/grad_norm/{m}" for m in ("world_model", "actor", "critic")}
    if not want <= set(probes) or summary["learn_criticals"] or not summary["learn_probe_fetches"]:
        raise AssertionError(f"{name}: learn probes {probes}, criticals {summary['learn_criticals']}, "
                             f"fetches {summary['learn_probe_fetches']}")
    return {"prof_captures": summary["prof_captures"], "device_ms_per_step": device_ms,
            "event_ms_per_replay": event_ms, "replays_timed": len(replays.ms),
            "device_ms_rel_gap": abs(device_ms - event_ms) / event_ms, "tolerance": TOL_PROF_DEVICE_MS,
            "mfu_device_pct": summary["mfu_device_pct"], "roofline_verdict": summary["roofline_verdict"],
            "bytes_per_train_step": summary["bytes_per_train_step"], "achieved_gbps": prof.get("achieved_gbps"),
            "bandwidth_util_pct": prof.get("bandwidth_util_pct"), "busy_frac": prof.get("busy_frac"),
            "window_ms": prof.get("window_ms"), "train_execs": prof.get("train_execs"), "gate_kernels": gates,
            "product_kernels": products, "cell_launches_in_window": launched,
            "learn_warnings": summary["learn_warnings"], "learn_criticals": summary["learn_criticals"],
            "window_events": prof.get("events"), "window_costs_s": prof.get("costs_s"),
            "learn_probe_fetches": summary["learn_probe_fetches"], "grad_norm_p95": summary["grad_norm_p95"],
            "update_ratio_p50": summary["update_ratio_p50"], "checks_s": time.perf_counter() - t0}


def _check_decoupled_telemetry(run: str, result, wall: float, keep_policies: int = 4) -> dict:
    """A decoupled telemetry run's ``telemetry.json``: the players' snapshots
    folded into the learner's counters (the slabs the loop received, the
    versions it published, the players as sources); for the 2-player run the
    staleness section (sample age, policy lag, the slab queue's depth), both
    players' watchdog beats, ``keep_policies`` versions in ``<log_dir>/policy/``
    with the learner's last the newest, and the learner's blocked seconds in
    ``publish``."""
    import glob

    t0 = time.perf_counter()
    summary = _telemetry_summary(result["log_dir"])
    plane = result["plane"]
    got = {"plane_traj_slabs": summary["plane_traj_slabs"], "plane_policy_version": summary["plane_policy_version"]}
    want = {"plane_traj_slabs": plane["slabs"], "plane_policy_version": plane["policy_version"]}
    players = {f"player{i}" for i in range(plane["players"])}
    if got != want or not players <= set(summary.get("sources") or {}):
        raise AssertionError(f"run_sac_decoupled {run}: telemetry.json reads {got} and sources "
                             f"{sorted(summary.get('sources') or {})}, the loop {want} and players {sorted(players)}")
    dumps = sorted(os.path.basename(p) for p in glob.glob(os.path.join(result["log_dir"], "telemetry", "flight_*.json"))
                   if not p.endswith("_summary.json"))
    line = {**got, "env_steps_async": summary["env_steps_async"], "policy_steps": result["policy_steps"],
            "sources": sorted(summary["sources"]), "flight_dumps": dumps,
            "policy_steps_per_s": result["policy_steps"] / wall}
    if run == "two_players":  # the flight recorder's profiler window (DECOUPLED_FLIGHT_CAPTURE_ARGS) parsed on the card
        windows = []
        for path in sorted(glob.glob(os.path.join(result["log_dir"], "telemetry", "flight_*_trace_summary.json"))):
            with open(path) as f:
                doc = json.load(f)
            windows.append({"file": os.path.basename(path), "source": doc["source"],
                            "kernels": sum((doc.get("kernel_counts") or {}).values()),
                            "train_module": doc["train_module"], "device_ms_per_step": doc["device_ms_per_step"]})
        if not windows or windows[0]["source"] != "device" or not windows[0]["kernels"] or \
                windows[0]["train_module"] != "train_step":
            raise AssertionError(f"run_sac_decoupled {run}: the flight dumps' profiler windows parse as {windows} "
                                 f"(dumps {dumps})")
        line["flight_windows"] = windows
    if run == "two_players":
        staleness = summary["staleness"] or {}
        if not (staleness.get("sample_age_s", {}).get("count") and staleness.get("policy_lag_versions", {}).get("count")
                and staleness.get("queue_depth", {}).get("plane_slab_queue", {}).get("samples")):
            raise AssertionError(f"run_sac_decoupled {run}: the staleness section reads {staleness}")
        beats = plane["watchdog_beats"]
        if sorted(beats) != list(range(plane["players"])) or not all(beats.values()):
            raise AssertionError(f"run_sac_decoupled {run}: the watchdog's player beats {beats}")
        versions = sorted(os.listdir(os.path.join(result["log_dir"], "policy")))
        if len(versions) != keep_policies or versions[-1] != f"policy_{plane['policy_version']:08d}":
            raise AssertionError(f"run_sac_decoupled {run}: <log_dir>/policy/ holds {versions}")
        publish = summary["phase_percentiles"]["Time/policy_publish_time"]
        line.update({"staleness": staleness, "watchdog_beats": beats, "policy_dir": versions,
                     "publish_blocked_s": result["seconds"]["publish"], "publish_span": publish,
                     "stalls": summary["stalls"]})
    line["checks_s"] = time.perf_counter() - t0
    TELEMETRY_CHECKS[f"run_sac_decoupled_{run}"] = line
    return line


def telemetry_line() -> dict:
    """The ``[telemetry]`` line: each telemetry run's policy steps/s beside
    PR 15's with the telemetry off, and the seconds its checks took."""
    if sorted(TELEMETRY_CHECKS) != sorted(PR15_TELEMETRY_OFF_POLICY_STEPS_PER_S):
        raise AssertionError(f"the telemetry checks ran on {sorted(TELEMETRY_CHECKS)}")
    return {name: {"policy_steps_per_s": line["policy_steps_per_s"],
                   "pr15_telemetry_off_policy_steps_per_s": PR15_TELEMETRY_OFF_POLICY_STEPS_PER_S[name],
                   "checks_s": line["checks_s"]} for name, line in sorted(TELEMETRY_CHECKS.items())}


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
    ``keep_root`` when given (its checkpoint outlives the phase). A spec
    with ``simulators`` runs over those stand-in simulators. Returns the
    run's launches and its checkpoint."""
    spec = RUN_SPECS[name]
    with _simulators(spec.get("simulators", ())):
        return _phase_run(card, name, spec, keep_root)


@contextlib.contextmanager
def _simulators(names):
    """The stand-in simulators ``names`` (``tests/sim_stubs.py``, duck-typed spaces) in ``sys.modules`` for the
    block: the port's real-simulator wrappers import and run over them."""
    if not names:
        yield {}
        return
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "sim_stubs.py")
    spec = importlib.util.spec_from_file_location("sim_stubs", path)
    sim_stubs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sim_stubs)

    try:
        yield sim_stubs.install(*names)
    finally:
        sim_stubs.uninstall(*names)


def _plain_cell_model(state, cfg, observation_space, action_space, version: int):
    """The served model of a checkpoint's ``state`` (read already, every
    crc32 verified) with its recurrent cell on the plain PyTorch version: what
    ``load_gateway_model(..., plain_cell=True)`` builds, without reading the
    checkpoint again."""
    from sheeprl_tpu_torch.evals.builders import actions_dim_of, serving_params
    from sheeprl_tpu_torch.serve.model import GatewayModel

    actions_dim, is_continuous = actions_dim_of(action_space)
    return GatewayModel.from_params(serving_params(state, str(cfg.algo.name)), cfg, observation_space.spaces,
                                    actions_dim, is_continuous, device="cuda", version=version, plain_cell=True)


def _phase_run(card: str, name: str, spec: dict, keep_root):
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.ckpt import validate_checkpoint
    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.serve.model import load_gateway_model
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    stamps = [("start", time.perf_counter())]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_run_") as tmp:
        root = keep_root or tmp
        torch.cuda.reset_peak_memory_stats()
        ops.hafner_cell_launches.reset()
        ops.hafner_sequence_launches.reset()
        # a run that opens its own profiler window (obs/prof) is not traced whole: one profiler session a process
        windowed = any(a.startswith("metric.telemetry.profile.every_n_steps=") for a in spec["args"])
        replays = _ReplayEvents() if windowed else contextlib.nullcontext()
        with (contextlib.nullcontext() if windowed else profile(activities=[ProfilerActivity.CUDA])) as prof, replays:
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
        telemetry = _check_run_telemetry(name, result, wall, graphs, peak) if "metric=telemetry" in spec["args"] else None
        if windowed:
            telemetry["prof"] = _check_run_prof(name, result, replays)

        ckpt = result["checkpoint"]
        if ckpt is None or not ckpt.endswith(f"ckpt_{result['policy_steps']}_0"):
            raise AssertionError(f"the run's last checkpoint is {ckpt}")
        # the manifest and every shard's size; then the whole state read once, every array's crc32 verified (what
        # deep validation reads), for both checks below (an XL checkpoint holds GBs)
        manifest = validate_checkpoint(ckpt)
        ckpt_bytes = sum(manifest["files"].values())
        state = _read_verified(ckpt)
        replay = spec["buffer"](state)
        if "buffer_keys" in spec and not set(spec["buffer_keys"]) <= set(replay["keys"]):
            raise AssertionError(f"the checkpoint's buffer holds {replay['keys']}, not all of {spec['buffer_keys']}")
        f32_parameters = _f32_parameters(state)

        stamps.append(("checks", time.perf_counter()))
        t0 = time.perf_counter()
        model, serve_cfg, obs_space, act_space = load_gateway_model(ckpt, device="cuda")
        torch.cuda.synchronize()
        cold_start_s = time.perf_counter() - t0
        frames = _serve_frames(spec["obs"], np.random.RandomState(SEED))
        ops.hafner_cell_launches.reset()
        actions, states, serve_wall, status = serve_lockstep(model, frames, seed=SEED)
        served_launches = ops.hafner_cell_launches.count
        if cell:  # the kernel path against a plain-cell replay, built from the state the checks read
            plain = _plain_cell_model(state, serve_cfg, obs_space, act_space, model.version)
            p_actions, p_states, _w, p_status = serve_lockstep(plain, frames, seed=SEED)
            del plain
        else:  # no kernel: the served actions against the evaluation policy's on the same frames and noise
            p_actions, p_states = eval_policy_lockstep(ckpt, frames, seed=SEED)
            p_status = {"failed_requests": 0}
        del state
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

        if windowed:  # the gate kernels held to the counters over the window (_check_run_prof), the busy share its
            window = telemetry["prof"]
            busy_us = window["busy_frac"] * window["window_ms"] * 1e3
            gate_kernels, product_kernels = window["gate_kernels"], window["product_kernels"]
        else:
            busy_us, found = trace_summary(prof, ("hafner_gates_kernel", "hafner_product_kernel"))
            gate_kernels, product_kernels = found["hafner_gates_kernel"], found["hafner_product_kernel"]
            if gate_kernels != launches["hafner_cell"]:
                raise AssertionError(
                    f"the trace holds {gate_kernels} hafner_gates_kernel runs, the counters {launches['hafner_cell']} "
                    "launches"
                )
        stamps.append(("trace_read", time.perf_counter()))

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
        # untraced run's); a windowed run's over its window
        "device_idle_share": (1.0 - telemetry["prof"]["busy_frac"]) if windowed else 1.0 - busy_us / 1e6 / wall,
        "rates_under_profiler": not windowed,
        "telemetry": telemetry,
        "card": card,
    }
    print(f"[{name}] " + json.dumps(line), flush=True)
    return launches, ckpt


def _minedojo_functional_counts(envs) -> dict:
    """The functional actions (the 8-entry action's entry 5) the MineDojo stand-ins received, by name."""
    names = ("no_op", "use", "drop", "attack", "craft", "equip", "place", "destroy")
    counts = dict.fromkeys(names, 0)
    for env in envs:
        for action in env.received:
            counts[names[int(action[5])]] += 1
    return counts


def _minedojo_player_lockstep(ckpt: str) -> dict:
    """The masked acting step on the card against the same step on the CPU:
    the run's checkpointed world model and actor, MINEDOJO_PLAYER_ENVS envs
    (the port's MineDojo wrapper over the stand-in, the run's env pipeline)
    stepped MINEDOJO_PLAYER_STEPS times with the card's actions. The card
    runs the run's acting step (``ExplorationStep``: its CUDA graph, the
    masks copied into its static buffers); the CPU runs the player's
    ``exploration_action`` from the card's state before the step, on the
    same observation, masks and noise (drawn on the host), with the plain
    cell; TF32 off on the card. Every head's action must be equal, the
    recurrent and stochastic states within TOL_STATE, and the stand-ins must
    flag none of the actions they received as forbidden by their masks.
    Returns the counts, the errors and the cell's launches."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import ExplorationStep, build_agent, build_player_fns
    from sheeprl_tpu_torch.algos.dreamer_v3.minedojo_actor import MASK_KEYS
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import normalize_obs, prepare_obs
    from sheeprl_tpu_torch.ckpt import read_checkpoint
    from sheeprl_tpu_torch.cli import load_run_config
    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.utils.env import build_env

    cfg, _log_dir = load_run_config(ckpt)
    n, expl = MINEDOJO_PLAYER_ENVS, MINEDOJO_PLAYER_EXPL
    envs = [build_env(cfg, SEED + i, 0, vector_env_idx=i) for i in range(n)]
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    space = envs[0].observation_space
    actions_dim = tuple(int(d) for d in envs[0].action_space.nvec)
    agent = read_checkpoint(ckpt, with_rb=False)["agent"]
    players = {}
    for device in ("cuda", "cpu"):
        # the checkpoint holds the whole training agent (the decoders too): build it whole, act with two modules
        world_model, actor, *_ = build_agent(cfg, actions_dim, False,
                                             {k: space[k].shape for k in cnn_keys + mlp_keys}, device=device,
                                             training=True)
        world_model.load_state_dict({k: torch.as_tensor(v) for k, v in agent["world_model"].items()})
        actor.load_state_dict({k: torch.as_tensor(v) for k, v in agent["actor"].items()})
        players[device] = build_player_fns(world_model, actor, cfg, actions_dim, False)

    def stacked(raw):
        return {k: np.stack([r[k] for r in raw]) for k in raw[0]}

    raw = stacked([env.reset(seed=SEED + i)[0] for i, env in enumerate(envs)])
    obs = prepare_obs(raw, cnn_keys, mlp_keys, n)
    masks = {k: raw[k] for k in MASK_KEYS}
    acting = ExplorationStep(players["cuda"], n, obs, cnn_keys, None, "cuda", reset_in_step=False,
                             masks_example=masks)
    generator = torch.Generator().manual_seed(SEED)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ops.hafner_cell_launches.reset()
    state_err, episodes = 0.0, 0
    try:
        for _ in range(MINEDOJO_PLAYER_STEPS):
            before = {k: v.detach().cpu().clone() for k, v in acting.state.items()}
            noise = players["cpu"]["draw_exploration_noise"](n, generator)
            card_actions = [a.cpu() for a in acting(obs, None, expl, noise=noise, masks=masks)]
            cpu_actions, cpu_state = players["cpu"]["exploration_action"](
                before, normalize_obs(obs, cnn_keys, torch.device("cpu")), expl, gumbel=noise["gumbel"],
                action_gumbels=noise["action_gumbels"], expl_noise=noise["expl_noise"],
                masks={k: torch.from_numpy(v) for k, v in masks.items()})
            for head, (a, b) in enumerate(zip(card_actions, cpu_actions)):
                if not torch.equal(a.argmax(-1), b.argmax(-1)):
                    raise AssertionError(f"the masked acting step's head {head}: card {a.argmax(-1).tolist()}, "
                                         f"CPU {b.argmax(-1).tolist()}")
            for k in ("recurrent", "stochastic"):
                state_err = max(state_err, (acting.state[k].cpu() - cpu_state[k]).abs().max().item())
            real = np.stack([a.argmax(-1).numpy() for a in card_actions], -1)
            steps = [env.step(real[i]) for i, env in enumerate(envs)]
            done = np.array([s[2] or s[3] for s in steps])
            raw = stacked([env.reset()[0] if d else s[0] for env, s, d in zip(envs, steps, done)])
            obs = prepare_obs(raw, cnn_keys, mlp_keys, n)
            masks = {k: raw[k] for k in MASK_KEYS}
            if done.any():
                episodes += int(done.sum())
                acting.reset(done.astype(np.float32).reshape(n, 1))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    launches = ops.hafner_cell_launches.count
    if state_err > TOL_STATE:
        raise AssertionError(f"the masked acting step's state: card against CPU {state_err} > {TOL_STATE}")
    if launches != MINEDOJO_PLAYER_STEPS:
        raise AssertionError(f"hafner_cell launched {launches} times on {MINEDOJO_PLAYER_STEPS} acting steps")
    stand_ins = [env.unwrapped.env for env in envs]
    invalid = [flag for stand_in in stand_ins for flag in stand_in.invalid]
    if invalid or sum(len(stand_in.received) for stand_in in stand_ins) != n * MINEDOJO_PLAYER_STEPS:
        raise AssertionError(f"the masked acting steps sent actions their masks forbid: {invalid[:4]}")
    return {"steps": MINEDOJO_PLAYER_STEPS, "envs": n, "episodes_ended": episodes, "actions_equal": True,
            "actions_invalid_under_masks": 0,
            "state_max_abs_err": state_err, "tol": TOL_STATE, "hafner_cell_launches": launches,
            "graph": {"eager_calls": acting.step.eager_calls, "replays": acting.step.replays},
            "functional_actions": _minedojo_functional_counts(stand_ins)}


def phase_run_minedojo(card: str) -> tuple:
    """``exp=dreamer_v3 env=minedojo`` through the CLI (RUN_MINEDOJO_ARGS)
    over the MineDojo stand-in, every one of its acting steps masked: its
    counts, the cell's launches (player steps + 79 a gradient step), its
    graphs, finite logged losses, no env restarted and none of the actions
    the stand-ins received flagged as forbidden by the masks they handed
    out; then ``_minedojo_player_lockstep`` on its checkpoint.
    Returns ``({path: launches}, line)``."""
    import math
    import tempfile
    import warnings

    import torch

    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS
    from sheeprl_tpu_torch.utils.tb_events import read_events

    with _simulators(("minedojo",)) as stand_in, tempfile.TemporaryDirectory(prefix="chip_smoke_minedojo_") as root:
        made, make = [], stand_in["minedojo"].make

        def recording_make(*args, **kwargs):
            env = make(*args, **kwargs)
            made.append(env)
            return env

        stand_in["minedojo"].make = recording_make
        ops.hafner_cell_launches.reset()
        ops.hafner_sequence_launches.reset()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            result, wall = _run_once(root, "run_dv3_minedojo", RUN_MINEDOJO_ARGS)
        launches = {"hafner_cell": ops.hafner_cell_launches.count, "hafner_sequence": ops.hafner_sequence_launches.count}
        restarts = [str(w.message) for w in caught if "Restarting env" in str(w.message)]
        if restarts:
            raise AssertionError(f"the MineDojo run restarted envs: {restarts[:2]}")
        counts = (result["updates"], result["player_steps"], result["gradient_steps"], result["test_steps"])
        if counts != RUN_MINEDOJO_COUNTS or result["random_steps"] != 0:
            raise AssertionError(f"the MineDojo run took (updates, player, gradient, test) steps {counts}, "
                                 f"{result['random_steps']} random")
        predicted = result["player_steps"] + DV3_CELL_LAUNCHES_PER_STEP * result["gradient_steps"]
        if launches != {"hafner_cell": predicted, "hafner_sequence": 0}:
            raise AssertionError(f"the MineDojo run launched {launches}, predicted {predicted} cells and 0 sequences")
        received = sum(len(env.received) for env in made)
        invalid = [flag for env in made for flag in env.invalid]
        if received != RUN_MINEDOJO_COUNTS[1] * 2 or invalid:
            raise AssertionError(f"the MineDojo stand-ins received {received} actions, these forbidden by their "
                                 f"masks: {invalid[:4]}")
        want_graphs = {"train": {"eager_calls": WARMUP_CALLS, "replays": counts[2] - WARMUP_CALLS, "captured": 1},
                       "act": {"eager_calls": WARMUP_CALLS, "replays": counts[1] - WARMUP_CALLS, "captured": 1}}
        graphs = {k: {n: v[n] for n in want_graphs[k]} for k, v in result["graphs"].items()}
        if graphs != want_graphs:
            raise AssertionError(f"the MineDojo run's steps ran as {result['graphs']}, expected {want_graphs}")
        logged = {}
        for e in read_events(result["event_file"])[1:]:
            for v in e.get("values", []):
                logged.setdefault(e["step"], {})[v["tag"]] = v.get("simple_value")
        losses = {tag: v for tag, v in logged.get(320, {}).items() if tag.startswith("Loss/")}
        if len(losses) < 7 or not all(v is not None and math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"the MineDojo run's losses at its last log: {losses}")
        functional = _minedojo_functional_counts(made)
        ops.hafner_cell_launches.reset()
        lockstep = _minedojo_player_lockstep(result["checkpoint"])
        torch.cuda.synchronize()
    line = {"run_args": list(RUN_MINEDOJO_ARGS), "counts": counts, "wall_s": wall,
            "policy_steps_per_s": result["policy_steps"] / wall, "hafner_cell_launches": launches["hafner_cell"],
            "hafner_cell_launches_predicted": predicted, "graphs": result["graphs"], "actions_received": received,
            "actions_invalid_under_masks": 0, "functional_actions": functional, "losses_at_last_log": losses,
            "player_card_against_cpu": lockstep, "card": card}
    print("[run_dv3_minedojo] " + json.dumps(line), flush=True)
    return ({"run_dv3_minedojo": launches,
             "dv3_minedojo_player": {"hafner_cell": lockstep["hafner_cell_launches"], "hafner_sequence": 0}}, line)


def phase_run_dv3_L(card: str) -> dict:
    """run_dv3_L's phase: the L DIAMBRA preset, then the L Navigate preset
    (``phase_run``), then the MineDojo run (``phase_run_minedojo``).
    Returns the paths' launches."""
    paths = {}
    for name in ("run_dv3_L", "run_dv3_L_navigate"):
        paths[name], _ckpt = phase_run(card, name)
    minedojo, _line = phase_run_minedojo(card)
    paths.update(minedojo)
    return paths


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


# the serving ops surface (ROADMAP 6g), on in the serve-command run: every 20th request of a client traced (its
# first among them), every 4th logged, /metrics on an ephemeral port, the SLO engine; its files in <work>/serve_obs
SERVE_TRACE_EVERY, SERVE_ACCESS_EVERY = 20, 4
SERVE_OPS_ARGS = (f"serve.trace_sample_rate={1 / SERVE_TRACE_EVERY}", f"serve.access_log_sample_rate={1 / SERVE_ACCESS_EVERY}",
                  "serve.metrics_port=0", "serve.slo.enabled=true")
SERVE_OBJECTIVES = {"act_latency_p99", "availability", "swap_staleness"}
SERVE_STAGES = ("client_enqueue", "ring_transit", "queue_wait", "batch_assembly", "device_dispatch", "respond")
# the fault drill: every dispatch delayed by DRILL_DELAY_S against a p99 bound of DRILL_P99_MS trips the fast burn
DRILL_DELAY_S, DRILL_P99_MS, DRILL_REQUESTS = 0.12, 20.0, 6
# --serve-ops: the serve command with its ops off and on, alternated (off, on, on, off), on a full-width DV3
# checkpoint of a run that only collects (RUN_DV3_ARGS cut to 16 policy steps)
SERVE_OPS_CKPT_ARGS = tuple(a for a in RUN_DV3_ARGS if not a.startswith("total_steps=")) + (
    "total_steps=16", "algo.learning_starts=1024")
# --serve-ops's second set of pairs: few enough client processes that they and the server leave the 8 cores unsaturated
SERVE_OPS_FEW_CLIENTS = 4
# the serve command's process, with the dispatcher thread's time measured inside it: every batch's _dispatch (its
# wall seconds and its end on the wall clock) and, within it, the ops sink's on_request and on_cancelled seconds;
# written at exit to $SERVE_COST_OUT, so the ops' cost a batch is read on the thread that pays it, however loaded the
# host is, and over the same steady window as the clients' latencies
SERVE_TIMED_MAIN = """
import json, os, sys, time
from sheeprl_tpu_torch.serve import batcher as _batcher, ops as _ops
batches, ops_s, ops_calls = [], [0.0], [0]
def timed_ops(fn):
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            ops_s[0] += time.perf_counter() - t0
            ops_calls[0] += 1
    return wrapper
def timed_dispatch(fn):
    def wrapper(self, batch):
        t0, o0 = time.perf_counter(), ops_s[0]
        try:
            return fn(self, batch)
        finally:
            batches.append((time.time(), time.perf_counter() - t0, ops_s[0] - o0))
    return wrapper
_batcher.RequestBatcher._dispatch = timed_dispatch(_batcher.RequestBatcher._dispatch)
_ops.ServeOps.on_request = timed_ops(_ops.ServeOps.on_request)
_ops.ServeOps.on_cancelled = timed_ops(_ops.ServeOps.on_cancelled)
from sheeprl_tpu_torch.cli import serve
try:
    serve(sys.argv[1:])
finally:
    with open(os.environ["SERVE_COST_OUT"], "w") as f:
        json.dump({"batches": batches, "ops_s": ops_s[0], "ops_calls": ops_calls[0]}, f)
"""


def _scrape_metrics(port: int, versions) -> dict:
    """One ``/metrics`` scrape of the serve command: every sample line parses
    as ``name{labels} value``, the stage percentiles are there, and the
    per-version request counts hold every version in ``versions``."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
        body = resp.read().decode()
    samples = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            samples[key] = float(value)
    by_version = {int(k.split('"')[1]): v for k, v in samples.items() if k.startswith("sheeprl_serve_version_requests{")}
    stages = sorted({k.split('"')[1] for k in samples if k.startswith("sheeprl_phase_duration_ms{")})
    if not all(by_version.get(int(v), 0) > 0 for v in versions) or "serve/queue_wait" not in stages:
        raise AssertionError(f"/metrics: requests by version {by_version} (want {list(versions)}), stages {stages}")
    return {"samples": len(samples), "requests_by_version": by_version, "stages": stages,
            "slo_objective_ok": {k.split('"')[1]: v for k, v in samples.items() if k.startswith("sheeprl_slo_objective_ok{")}}


def _percentiles(values) -> dict:
    import numpy as np

    return {"p50": float(np.percentile(values, 50)), "p99": float(np.percentile(values, 99)), "n": len(values)}


def _first_answer_split(obs_dir: str, t_up_wall: float, n_clients: int) -> dict:
    """Each ring client's first answer, split by stage: its process's start
    (the serve command's "gateway up" line to the client's first ``act``
    entry, on the wall clock through the client lane's ``clock_sync``
    anchor), then the six traced stages of its first request (every
    client's first request is traced: trace id (slot+1)·10^6 + 1). Also the
    traced stages' p50/p99 over every sampled request. Milliseconds."""
    import numpy as np

    anchor, spans = None, {}
    for lane in ("client", "gateway"):
        with open(os.path.join(obs_dir, f"trace_serve_{lane}.jsonl")) as f:
            for line in f:
                ev = json.loads(line)
                if ev.get("ph") == "M" and ev.get("name") == "clock_sync" and lane == "client":
                    anchor = float(ev["args"]["unix_ts"])
                elif ev.get("ph") == "X":
                    spans.setdefault(ev["args"]["trace_id"], {})[ev["name"][len("serve/"):]] = ev
    firsts = [spans.get((slot + 1) * 1_000_000 + 1) for slot in range(n_clients)]
    if anchor is None or any(f is None or set(f) != set(SERVE_STAGES) for f in firsts):
        raise AssertionError(f"serve: {sum(f is None for f in firsts)} clients' first requests untraced")
    split = {"client_start": [1e3 * (anchor + f["client_enqueue"]["ts"] / 1e6 - t_up_wall) for f in firsts]}
    for stage in SERVE_STAGES:
        split[stage] = [f[stage]["dur"] / 1e3 for f in firsts]
    total = [sum(split[k][i] for k in split) for i in range(n_clients)]
    medians = {k: float(np.median(v)) for k, v in split.items()}
    return {
        "first_answer_ms": {k: {"median": medians[k], "max": float(np.max(v))} for k, v in split.items()},
        "first_answer_total_ms": {"median": float(np.median(total)), "max": float(np.max(total))},
        "first_answer_dominant_stage": max(medians, key=medians.get),
        "traced_requests": len(spans),
        "traced_stage_ms": {stage: _percentiles([s[stage]["dur"] / 1e3 for s in spans.values() if stage in s])
                            for stage in SERVE_STAGES},
    }


def _check_serve_ops(obs_dir: str, records, final: dict, t_up_wall: float) -> dict:
    """The serve command's ops files: ``serve_live.json``'s requests equal the
    clients' records, the access log holds every SERVE_ACCESS_EVERY-th and
    the traces every client's every SERVE_TRACE_EVERY-th request, and
    ``serve_report --json`` gives each objective a verdict (its exit code 1
    exactly when one FAILs)."""
    from sheeprl_tpu_torch.tools import serve_report

    for name in ("serve_live.json", "access.jsonl", "trace_serve_client.jsonl", "trace_serve_gateway.jsonl"):
        if not os.path.exists(os.path.join(obs_dir, name)):
            raise AssertionError(f"serve ops: no {name} in {obs_dir}")
    with open(os.path.join(obs_dir, "serve_live.json")) as f:
        live = json.load(f)
    requests = sum(len(r["versions"]) for r in records)
    traced = sum(-(-len(r["versions"]) // SERVE_TRACE_EVERY) for r in records)
    with open(os.path.join(obs_dir, "access.jsonl")) as f:
        access = sum(1 for line in f if line.strip())
    if (live["requests"] != requests or final["requests"] != requests or access != -(-requests // SERVE_ACCESS_EVERY)
            or live["trace_sampled_requests"] != traced):
        raise AssertionError(f"serve ops: serve_live.json counts {live['requests']} requests, {live['trace_sampled_requests']}"
                             f" traced; the clients {requests}, {traced} traced; {access} access-log lines")
    rc = serve_report.main([obs_dir, "--json"])
    with open(os.path.join(obs_dir, "serve_report.json")) as f:
        report = json.load(f)
    verdicts = {name: obj.get("verdict") for name, obj in report["objectives"].items()}
    if set(verdicts) != SERVE_OBJECTIVES or not set(verdicts.values()) <= {"PASS", "FAIL"} or (
            rc != (1 if "FAIL" in verdicts.values() else 0)):
        raise AssertionError(f"serve_report: exit {rc}, verdicts {verdicts}")
    return {"verdicts": verdicts, "serve_report_rc": rc, "alerts_fired": report["alerts"]["fired"],
            "flight_slo_burn_dumps": len(report["flights"]), "access_log_lines": access, "traced_requests": traced,
            "server_stage_ms": live["phase_percentiles"], **_first_answer_split(obs_dir, t_up_wall, len(records))}


def _serve_fault_drill(gateway, obs_dir: str) -> dict:
    """The SLO fault drill on the card, in process: ``gateway`` with
    ``inject_dispatch_delay_s`` = DRILL_DELAY_S against a p99 bound of
    DRILL_P99_MS serves DRILL_REQUESTS requests; one engine tick fires the
    fast burn, the flight recorder dumps ``flight_slo_burn_*.json``, the
    delay is charged to ``device_dispatch`` and ``serve_report`` exits 1."""
    import glob

    import numpy as np

    from sheeprl_tpu_torch.obs import counters as obs_counters
    from sheeprl_tpu_torch.tools import serve_report

    previous, counters = obs_counters.installed(), obs_counters.Counters()
    obs_counters.install(counters)
    try:
        ops = gateway.enable_ops({"inject_dispatch_delay_s": DRILL_DELAY_S,
                                  "slo": {"enabled": True, "eval_interval_s": 3600.0,  # the drill drives the tick
                                          "objectives": {"act_latency_p99_ms": DRILL_P99_MS}}}, out_dir=obs_dir)
        rng = np.random.default_rng(SEED)
        client = gateway.client("drill")
        for i in range(DRILL_REQUESTS):
            client.act({k: rng.integers(0, 256, s.shape, dtype=np.uint8) if s.dtype == np.uint8
                        else rng.standard_normal(s.shape).astype(s.dtype)
                        for k, s in gateway.observation_space.spaces.items()}, reset=i == 0)
        ops.slo_tick()
        fired = sorted({r["alert"] for r in ops.slo.alert_log if r["event"] == "fire"
                        and r["objective"] == "act_latency_p99"})
        dispatch_p50 = gateway.status()["stage_latency"]["device_dispatch"]["p50_ms"]
        verdict = ops.slo.verdicts()["act_latency_p99"]
    finally:
        obs_counters.install(previous)
        gateway.close()
    flights = glob.glob(os.path.join(obs_dir, "flight_slo_burn_*.json"))
    rc = serve_report.main([obs_dir])
    if ("fast_burn" not in fired or counters.slo_alerts_fired < 1 or verdict != "FAIL" or not flights or rc != 1
            or dispatch_p50 < 1e3 * DRILL_DELAY_S):
        raise AssertionError(f"fault drill: fired {fired}, {counters.slo_alerts_fired} alerts counted, verdict {verdict}, "
                             f"{len(flights)} flight dumps, serve_report exit {rc}, dispatch p50 {dispatch_p50} ms")
    return {"inject_dispatch_delay_s": DRILL_DELAY_S, "p99_bound_ms": DRILL_P99_MS, "requests": DRILL_REQUESTS,
            "fired": fired, "verdict": verdict, "flight_slo_burn_dumps": len(flights), "serve_report_rc": rc,
            "device_dispatch_p50_ms": dispatch_p50}


def _serve_command(ckpt_ref: str, reg: str, base_ckpt: str, work: str, ops: bool = True,
                   clients: int = SERVE_CLIENTS) -> dict:
    """The serve command in a subprocess (``cli.serve`` with serve.duration_s
    as a limit), its ring driven by ``clients`` spawned seeded clients.
    Once every client has had an answer, the steady window starts;
    SERVE_PUBLISH_AFTER_S seconds into it perturbed weights are published
    into the watched ``poll_root``, SERVE_STOP_AFTER_S seconds later the
    clients are stopped (a stop file), and once every client has written its
    record the command gets SIGTERM. Requests/s and latency are read over the
    steady window. With ``ops`` every ops knob is on (SERVE_OPS_ARGS, files in
    ``<work>/serve_obs``): ``/metrics`` is scraped once at the end of the
    steady window, after the swap (both versions' requests), and the files
    are checked (``_check_serve_ops``)."""
    import signal
    import threading

    import numpy as np

    from sheeprl_tpu_torch.ckpt import read_checkpoint
    from sheeprl_tpu_torch.evals.service import policy_version_of
    from sheeprl_tpu_torch.plane.publish import PolicyPublisher

    repo = os.path.dirname(os.path.abspath(__file__))
    pol, out = os.path.join(work, "policies"), os.path.join(work, "clients")
    base = policy_version_of(base_ckpt)
    cmd = [sys.executable, "-c", SERVE_TIMED_MAIN,
           f"checkpoint_path={ckpt_ref}", f"serve.registry_dir={reg}", "serve.duration_s=150",
           f"serve.max_clients={clients}", f"serve.poll_root={pol}", "serve.poll_interval_s=0.2",
           f"serve.clients.n={clients}", "serve.clients.entry=sheeprl_tpu_torch.serve.loadgen:seeded_client",
           f"serve.clients.spec.duration_s={SERVE_CLIENT_CAP_S}", f"serve.clients.spec.out_dir={out}",
           f"serve.clients.spec.stop_file={os.path.join(out, 'stop')}", f"serve.clients.spec.seed={SEED}"]
    obs_dir = os.path.join(work, "serve_obs")
    if ops:
        cmd += [*SERVE_OPS_ARGS, f"serve.obs_dir={obs_dir}"]
    cost_out = os.path.join(work, "serve_cost.json")
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""), SERVE_COST_OUT=cost_out)
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
            while len([f for f in os.listdir(out) if f.endswith(suffix)] if os.path.isdir(out) else []) < clients:
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
        scrape = None
        if ops:
            port = [line.split("metrics_port=")[1].split()[0] for line in lines if "[serve] ops surface on" in line]
            scrape = _scrape_metrics(int(port[0]), (base, new_version))
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
    with open(cost_out) as f:
        cost = json.load(f)
    if len(cost["batches"]) < final["batches"] or bool(cost["ops_calls"]) != ops:
        raise AssertionError(f"serve: {len(cost['batches'])} dispatches timed for {final['batches']} batches, "
                             f"{cost['ops_calls']} ops calls, ops {ops}")
    records = []
    for slot in range(clients):
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
    # the dispatcher thread over the same window: its seconds a batch, and the ops sink's within them
    dispatch_s, sink_s = np.array([(d, o) for t, d, o in cost["batches"] if t_all <= t <= t_stop]).T
    new_at = [t for r in records for t, v in zip(r["answered_at"], r["versions"]) if v == new_version]
    row = {"clients": clients, "steady_window_s": t_stop - t_all, "requests": requests,
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
           "up_to_all_clients_answered_s": t_all - t_up_wall, "ops": ops,
           # the dispatcher thread's own ms a batch over the steady window, and the ops sink's within them (0 off)
           "steady_batches": len(dispatch_s), "dispatcher_ms_p50": 1e3 * float(np.percentile(dispatch_s, 50)),
           "dispatcher_ms_p99": 1e3 * float(np.percentile(dispatch_s, 99)),
           "ops_ms_p50": 1e3 * float(np.percentile(sink_s, 50)), "ops_ms_p99": 1e3 * float(np.percentile(sink_s, 99)),
           "ops_share_of_dispatcher": float(sink_s.sum() / dispatch_s.sum()), "ops_calls": cost["ops_calls"]}
    checked = {"metrics": scrape, **_check_serve_ops(obs_dir, records, final, t_up_wall)} if ops else None
    return {"row": row, "launches": launches, "ops": checked}


SERVE_OPS_KEYS = ("requests_per_s", "act_latency_p50_ms", "act_latency_p99_ms", "steady_requests", "mean_batch_occupancy",
                  "up_to_all_clients_answered_s", "steady_batches", "dispatcher_ms_p50", "dispatcher_ms_p99", "ops_ms_p50",
                  "ops_ms_p99", "ops_share_of_dispatcher")


def _serve_ops_line(on: dict, off_rows, drill: dict, card: str) -> dict:
    """The ``[serve_ops]`` line: the serve command's steady window with the ops
    on (``on``, a ``_serve_command`` result) beside ``off_rows`` (the same
    command's rows with them off, when the call made any), its ops checks
    and first-answer split, and the fault drill."""
    return {"on": {k: on["row"][k] for k in SERVE_OPS_KEYS},
            "off": [{k: row[k] for k in SERVE_OPS_KEYS} for row in off_rows] if off_rows else
            "not run in this call: python3 chip_smoke.py --serve-ops alternates the command off and on",
            **on["ops"], "fault_drill": drill, "card": card}


def phase_eval_serve(card: str, work: str, dv3_ckpt: str, walker_ckpt: str):
    """The eval and serve paths: the evaluation command on run_dv3's and
    run_walker's checkpoints (``_eval_command``), the registration command
    and the gateway-path rescore of ``registry:best:dreamer_v3:<env>``
    (returns, lengths and every step's actions bit for bit the evaluation's,
    one cell launch a batch), the cold start through that ref (its gateway
    then runs the SLO fault drill, ``_serve_fault_drill``), the serve
    command under load with a hot-swap, every ops knob on and a SIGTERM drain
    (``_serve_command``, the ``[serve_ops]`` line), and in-run evaluation on a short DV3 run
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
        drill = _serve_fault_drill(gateway, os.path.join(work, "drill_obs"))  # closes the gateway
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
        print("[serve_ops] " + json.dumps(_serve_ops_line(serve, None, drill, card)), flush=True)

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
    manifest = validate_checkpoint(ckpt)  # every shard's size; the read below verifies every array's crc32
    return {"predicted_cell_launches": predicted, "graphs": result["graphs"], "checkpoint": ckpt,
            "checkpoint_bytes": sum(manifest["files"].values()),
            "checkpoint_parameters": _f32_parameters(_read_verified(ckpt)),
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
    A spec with ``simulators`` runs over those stand-in simulators.
    Returns the launches by path."""
    spec = RUN_P2E_SPECS[family]
    with _simulators(spec.get("simulators", ())):
        return _phase_run_p2e(card, family, work, spec)


def _phase_run_p2e(card: str, family: str, work: str, spec: dict):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.serve.model import load_gateway_model

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


# ---------------------------------------------------------------------------
# the SAC family (SAC, DroQ, SAC-AE) and the device envs behind env.backend=jax
# ---------------------------------------------------------------------------

# the trainers at their presets' widths on walker_stand_in's spaces (the vector state for SAC and DroQ, the RGB
# frames stacked 3 deep for SAC-AE; 6 actions in [-1, 1]): SAC hidden 256, B 256, 2 critics; DroQ the same at
# G = 20 and dropout 0.01; SAC-AE B 128, 16 x 32 channels, features 64, hidden 1024
SAC_TRAINERS = {
    "sac": dict(exp="sac", obs={"state": (24,)}, batch=256),
    "droq": dict(exp="droq", obs={"state": (24,)}, batch=256),
    "sac_ae": dict(exp="sac_ae", obs={"rgb": (9, 64, 64)}, batch=128),
}
# the card's step against the CPU's steps in float32 and float64: a small batch, the critics' learning rate 0 (their
# update precedes the actor's, alpha's and the decoder's losses, which then read the same critic and encoder)
SAC_CPU_BATCH = {"sac": 16, "droq": 16, "sac_ae": 4}
SAC_TIMED_STEPS = {"sac": 50, "droq": 10, "sac_ae": 4}
# the runs through the CLI on walker_stand_in (exp=sac, exp=droq, exp=sac_ae at their widths): 2 envs, a 64-step
# time limit (the stand-in never terminates), a 4096-row buffer (1e6 in the presets); SAC and DroQ learn from the
# presets' 100 policy steps; SAC-AE from 16 (1000 in the preset) over 48 policy steps (its step is ~0.4 s)
_SAC_RUN_ENV = ("env.wrapper._target_=chip_smoke.walker_stand_in", "env.id=walker_walk", "env.num_envs=2",
                "env.sync_env=True", "env.capture_video=False", "env.max_episode_steps=64", "metric.log_level=1")
SAC_RUN_SPECS = {
    "run_sac": ("sac", ("exp=sac", *_SAC_RUN_ENV, "mlp_keys.encoder=[state]", "buffer.size=4096",
                        "total_steps=512", "checkpoint.every=512", "metric.log_every=256")),
    "run_droq": ("droq", ("exp=droq", *_SAC_RUN_ENV, "mlp_keys.encoder=[state]", "buffer.size=4096",
                          "total_steps=256", "checkpoint.every=256", "metric.log_every=128")),
    "run_sac_ae": ("sac_ae", ("exp=sac_ae", *_SAC_RUN_ENV, "buffer.size=256", "algo.learning_starts=16",
                              "total_steps=48", "checkpoint.every=48", "metric.log_every=48")),
}
# test_sac_learns_pendulum's settings (tests/test_algos/test_learning.py) on the port's own Pendulum: 4 envs,
# 32,768 policy steps, learning from 1000, batch 128, seed 3 (the JAX test's); its criterion: more than 30
# episodes, the last 10's mean return above -700 and 300 above the first 10's
RUN_PENDULUM_ARGS = ("exp=sac", "env.backend=jax", "env.id=Pendulum-v1", "env.num_envs=4", "total_steps=32768",
                     "algo.learning_starts=1000", "per_rank_batch_size=128", "metric.log_level=0",
                     "checkpoint.every=100000000", "checkpoint.save_last=False", "algo.run_test=False",
                     "buffer.memmap=False", "seed=3")
SAC_EVAL_EPISODES = 4


def _sac_cfg(algo: str, **overrides):
    from sheeprl_tpu_torch.config import compose

    return compose(overrides=[f"exp={SAC_TRAINERS[algo]['exp']}"] + [f"{k}={v}" for k, v in overrides.items()])


def sac_trainer(algo: str, device, batch=None, seed: int = 0, **overrides):
    """``(cfg, state, program, data)``: the preset's agent from seeded weights
    (made on the CPU, then moved), its optimizers, its step program and one
    seeded batch of ``batch`` rows (the preset's by default; DroQ's a G-step
    critic batch and its actor batch)."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.droq import droq
    from sheeprl_tpu_torch.algos.sac import sac
    from sheeprl_tpu_torch.algos.sac.agent import build_agent_state
    from sheeprl_tpu_torch.algos.sac_ae import sac_ae
    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
    from sheeprl_tpu_torch.envs import spaces

    spec = SAC_TRAINERS[algo]
    cfg = _sac_cfg(algo, **overrides)
    b = int(batch or spec["batch"])
    gen = torch.Generator().manual_seed(seed)
    if algo == "sac":
        agent = build_agent_state(24, WALKER_ACTIONS, int(cfg.algo.actor.hidden_size), int(cfg.algo.critic.hidden_size),
                                  int(cfg.algo.critic.n), float(cfg.algo.alpha.alpha), gen, device=device)
        state, program = sac.build_optimizers_and_state(cfg, agent), sac.build_train_fn(cfg, WALKER_ACTIONS, -6.0)
    elif algo == "droq":
        agent = droq.build_agent_state(24, WALKER_ACTIONS, cfg, gen, device)
        state, program = sac.build_optimizers_and_state(cfg, agent), droq.build_train_fn(cfg, WALKER_ACTIONS, -6.0)
    else:
        space = spaces.Dict({"rgb": spaces.Box(0, 255, spec["obs"]["rgb"], np.uint8)})
        agent = build_agent(cfg, WALKER_ACTIONS, space, gen, device=device)
        state, program = sac_ae.build_optimizers_and_state(cfg, agent), sac_ae.build_train_fn(cfg, WALKER_ACTIONS, -6.0)
    state["action_scale"] = torch.ones(WALKER_ACTIONS, device=device)
    state["action_bias"] = torch.zeros(WALKER_ACTIONS, device=device)
    rng = np.random.RandomState(seed)
    lead = (int(cfg.algo.per_rank_gradient_steps), b) if algo == "droq" else (b,)
    data = {"actions": rng.uniform(-1, 1, lead + (WALKER_ACTIONS,)).astype(np.float32),
            "rewards": rng.rand(*lead, 1).astype(np.float32), "dones": np.zeros(lead + (1,), np.float32)}
    for k, shape in spec["obs"].items():
        name = "observations" if algo != "sac_ae" else k
        for prefix in ("", "next_"):
            data[prefix + name] = (rng.randint(0, 256, lead + shape).astype(np.uint8) if len(shape) == 3
                                   else rng.randn(*lead, *shape).astype(np.float32))
    if algo == "droq":
        data["actor_observations"] = rng.randn(b, 24).astype(np.float32)
    data = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    return cfg, state, program, data


def _sac_gates(algo: str, cfg, i: int = 0):
    """The gates of gradient step ``i``: SAC's and DroQ's EMA on; SAC-AE's
    cadences cycling through all four (EMA, actor, decoder) combinations."""
    from sheeprl_tpu_torch.algos.sac.sac import ema_gates
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import cadence_gates

    if algo != "sac_ae":
        return ema_gates(True, float(cfg.algo.tau))
    return cadence_gates(cfg, i % 2 == 0, i % 3 != 1, i % 4 != 3)


def _first_moments(state) -> dict:
    return {f"{name}.{i}": opt.state[p]["exp_avg"].detach().float().cpu()
            for name, opt in state["opt"].items() for group in opt.param_groups for i, p in enumerate(group["params"])}


def _in_f64(state, data) -> None:
    """A trainer's modules, ``log_alpha``, optimizer state and float batch in
    float64, in place (the reference step)."""
    import torch

    for module in state.values():
        if isinstance(module, torch.nn.Module):
            module.double()
    state["log_alpha"].data = state["log_alpha"].data.double()
    for opt in state["opt"].values():
        for per_param in opt.state.values():
            for k in per_param:
                per_param[k] = per_param[k].double()
    for k in ("action_scale", "action_bias"):
        state[k] = state[k].double()
    for k, v in data.items():
        if v.dtype == torch.float32:
            data[k] = v.double()


def _sac_card_against_cpu(algo: str) -> dict:
    """One step of the preset at SAC_CPU_BATCH rows on the card (float32,
    TF32 off) and on the CPU in float32 and float64, from the same weights,
    batch and noise (drawn on the CPU, copied), with the critics' learning
    rate 0. Held, as the Dreamer phases hold their losses and Grads/ norms:
    each loss within TOL_TRAIN_LOSS and each optimizer's gradient norm (its
    first moments are 0.1 x its gradient after one step) within
    TOL_TRAIN_GRAD, relative, of the CPU's float32 step or of its float64
    step. The float64 step is the exact one; the float32 one shares the
    card's float32 artifacts (a saturated tanh's log-prob: on the H100's
    host SAC's value loss moves by 3.9e-4 between the CPU's float32 and
    float64 steps at B=16), and may itself be the inexact side (there the
    CPU's float32 SAC-AE encoder gradient norm sits 2.0e-4 from float64, the
    card's 9.0e-6). Reported: both gaps, and each optimizer's gradient's
    relative L2 distance to the float64 step, the card's and the CPU's
    float32 step's."""
    import math

    import torch

    from sheeprl_tpu_torch.kernels import ops

    metrics, moments, noise = {}, {}, None
    for side in ("cpu64", "cpu32", "cuda"):
        device = "cuda" if side == "cuda" else "cpu"
        cfg, state, program, data = sac_trainer(algo, device, SAC_CPU_BATCH[algo],
                                                **{"algo.critic.optimizer.lr": 0.0})
        if noise is None:
            noise = program._draw_noise(state, data, torch.Generator().manual_seed(SEED), "cpu")
        dtype = torch.float64 if side == "cpu64" else torch.float32
        if side == "cpu64":
            _in_f64(state, data)
        before = ops.hafner_cell_launches.count
        out = program(state, data, {k: v.to(device, dtype if v.is_floating_point() else v.dtype)
                                    for k, v in noise.items()}, _sac_gates(algo, cfg))
        metrics[side] = out.double().cpu().tolist()
        moments[side] = _first_moments(state)
        if side == "cuda":
            launches = ops.hafner_cell_launches.count - before
        del state, program, data
    torch.cuda.empty_cache()

    def norm(tensors):
        return math.sqrt(sum(float((t.double() ** 2).sum()) for t in tensors))

    def gaps(side, ref):
        by_opt = {}
        for k, r in moments[ref].items():
            by_opt.setdefault(k.rsplit(".", 1)[0], []).append((r, moments[side][k]))
        nonzero = {name: pairs for name, pairs in by_opt.items() if norm([r for r, _ in pairs]) > 0}
        return {
            "loss_rel_diff": {name: abs(g - r) / max(abs(r), 1e-6) for name, g, r in
                              zip(("value", "policy", "alpha", "reconstruction"), metrics[side], metrics[ref])},
            "grad_norm_rel_diff": {name: abs(norm([g for _, g in pairs]) - norm([r for r, _ in pairs]))
                                   / norm([r for r, _ in pairs]) for name, pairs in nonzero.items()},
            "grad_rel_l2_distance": {name: norm([g.double() - r.double() for r, g in pairs])
                                     / norm([r for r, _ in pairs]) for name, pairs in nonzero.items()},
        }

    against32, against64, cpu32 = gaps("cuda", "cpu32"), gaps("cuda", "cpu64"), gaps("cpu32", "cpu64")
    outside = [f"{kind}:{name}" for kind, limit in (("loss_rel_diff", TOL_TRAIN_LOSS),
                                                    ("grad_norm_rel_diff", TOL_TRAIN_GRAD))
               for name in against32[kind] if not min(against32[kind][name], against64[kind][name]) <= limit]
    return {"card": metrics["cuda"], "cpu32": metrics["cpu32"], "cpu64": metrics["cpu64"],
            "card_against_cpu32": against32, "card_against_cpu64": against64, "cpu32_against_cpu64": cpu32,
            "limits": [TOL_TRAIN_LOSS, TOL_TRAIN_GRAD], "outside": outside, "cell_launches": launches}


def _sac_graphed_against_eager(algo: str) -> dict:
    """GRAPH_STEPS full-width steps from one seed on one batch: eager
    (``program(...)``) and graphed (``program.burst``: the capture's eager
    warm-up calls, the capture, replays), the same noise (drawn once on the
    card) and gates; every step's losses and the final parameters."""
    import torch

    runs = {}
    for mode in ("eager", "graphed"):
        cfg, state, program, data = sac_trainer(algo, "cuda")
        if mode == "eager":
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            noises = [program._draw_noise(state, data, gen, "cuda") for _ in range(GRAPH_STEPS)]
            out = [program(state, data, noises[i], _sac_gates(algo, cfg, i)).cpu() for i in range(GRAPH_STEPS)]
        else:
            import numpy as np

            gates = np.stack([_sac_gates(algo, cfg, i) for i in range(GRAPH_STEPS)])
            stack = {k: v[None].expand(GRAPH_STEPS, *v.shape) for k, v in data.items()}
            out = []
            for i in range(GRAPH_STEPS):
                out.append(program.burst(state, {k: v[i:i + 1] for k, v in stack.items()}, gates[i],
                                         noise=[noises[i]]).cpu())
        params = {f"{n}.{k}": v.detach().cpu().clone() for n, m in state.items() if isinstance(m, torch.nn.Module)
                  for k, v in m.named_parameters()}
        params["log_alpha"] = state["log_alpha"].detach().cpu().clone()
        runs[mode] = {"metrics": [dict(enumerate(o.tolist())) for o in out], "params": params,
                      "graph": None if program.static is None else {
                          "eager_calls": program.static.step.eager_calls, "replays": program.static.step.replays,
                          "captured": program.static.step.graph is not None}}
        del state, program, data
    torch.cuda.empty_cache()
    return {**_steps_diff(runs["graphed"], runs["eager"]), "graph": runs["graphed"]["graph"]}


def phase_train_sac(card: str, algo: str):
    """SAC's, DroQ's or SAC-AE's gradient step at the preset's full width
    (``SAC_TRAINERS``). None of them reaches a TPU kernel, so the checks are
    the card's step against the port's own CPU step in float32 or float64
    (``_sac_card_against_cpu``; the CPU tests hold that step against JAX), GRAPH_STEPS steps graphed against
    eager with cuDNN deterministic, and 0 ``hafner_cell`` launches; then
    SAC_TIMED_STEPS graphed steps under the profiler (device time a step,
    idle share, top operations) and the peak memory."""
    import math

    import numpy as np
    import torch

    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.tools.bench_dreamer import profile_steps
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    tag = f"train_{algo}"
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        against_cpu = _sac_card_against_cpu(algo)
        torch.backends.cudnn.deterministic = True
        graphed = _sac_graphed_against_eager(algo)
        torch.backends.cudnn.deterministic = prev[2]
        ops.hafner_cell_launches.reset()
        ops.hafner_sequence_launches.reset()
        torch.cuda.reset_peak_memory_stats()
        cfg, state, program, data = sac_trainer(algo, "cuda")
        n = SAC_TIMED_STEPS[algo]
        gates = np.stack([_sac_gates(algo, cfg, i) for i in range(n)])
        stack = {k: v[None] for k, v in data.items()}
        for i in range(WARMUP_CALLS + 1):  # the warm-up calls and the capture
            program.burst(state, stack, gates[i % n])
        calls = iter(range(10**9))
        profiled = profile_steps(lambda: program.burst(state, stack, gates[next(calls) % n]), n)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            metrics = program.burst(state, stack, gates[i])
        end.record()
        torch.cuda.synchronize()
        launches = {"hafner_cell": ops.hafner_cell_launches.count, "hafner_sequence": ops.hafner_sequence_launches.count}
        peak = torch.cuda.max_memory_allocated()
        losses = metrics.cpu().tolist()
        del state, program, data
        torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = prev
    line = {"card_vs_cpu": against_cpu, "graphed_vs_eager": graphed, "steps": GRAPH_STEPS, "tol": TOL_GRAPHED,
            "ms_per_step_graphed": start.elapsed_time(end) / n, "profiled": profiled, "last_losses": losses,
            "peak_device_memory_bytes": peak, "launches": launches, "card": card}
    print(f"[{tag}] " + json.dumps(line), flush=True)
    bad = list(against_cpu["outside"])
    bad += [k for k, v in zip(("value", "policy", "alpha", "reconstruction"), against_cpu["card"])
            if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{tag}: the card's step and the CPU's steps disagree on {bad}")
    if graphed["metric_max_rel_err"] > TOL_GRAPHED or graphed["param_max_rel_err"] > TOL_GRAPHED:
        raise AssertionError(f"{tag}: graphed and eager steps disagree: {graphed}")
    if graphed["graph"] != {"eager_calls": WARMUP_CALLS, "replays": GRAPH_STEPS - WARMUP_CALLS, "captured": True}:
        raise AssertionError(f"{tag}: the graphed steps ran as {graphed['graph']}")
    if against_cpu["cell_launches"] or launches["hafner_cell"] or launches["hafner_sequence"]:
        raise AssertionError(f"{tag}: a SAC-family step launched a GRU kernel: {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: a loss is not finite: {losses}")
    return launches, {"card_vs_cpu_loss_max_rel_diff": max(
                          min(g, against_cpu["card_against_cpu64"]["loss_rel_diff"][k])
                          for k, g in against_cpu["card_against_cpu32"]["loss_rel_diff"].items()),
                      "card_vs_cpu_grad_norm_max_rel_diff": max(
                          min(g, against_cpu["card_against_cpu64"]["grad_norm_rel_diff"][k])
                          for k, g in against_cpu["card_against_cpu32"]["grad_norm_rel_diff"].items()),
                      "card_vs_cpu64_grad_rel_l2_distance": against_cpu["card_against_cpu64"]["grad_rel_l2_distance"],
                      "graphed_vs_eager": {k: graphed[k] for k in ("metric_max_rel_err", "param_max_rel_err",
                                                                      "bit_for_bit")},
                      "ms_per_step_graphed": line["ms_per_step_graphed"],
                      "device_idle_share": profiled["device_idle_share"],
                      "peak_device_memory_bytes": peak}


def _sac_run_predicted(algo: str, cfg) -> dict:
    """A run's counters from the loop's arithmetic, for a Python-plane run
    of ``cfg`` (one update a policy step of the ``n`` envs)."""
    n = int(cfg.env.num_envs)
    updates, ls = int(cfg.total_steps) // n, int(cfg.algo.learning_starts) // n
    g = int(cfg.algo.per_rank_gradient_steps)
    every = lambda f: int(f) // n + 1  # noqa: E731
    out = {"updates": updates, "random_steps": min(ls, updates), "player_steps": updates - min(ls, updates),
           "gradient_steps": 0, "ema_steps": 0, "train_calls": 0}
    for u in range(1, updates + 1):
        if algo == "droq":
            if u > ls:
                out["gradient_steps"] += g
                out["ema_steps"] += g
                out["actor_steps"] = out.get("actor_steps", 0) + 1
                out["train_calls"] += 1
            continue
        if u < ls:
            continue
        steps = (ls if u == ls else 1) * g
        out["gradient_steps"] += steps
        out["train_calls"] += steps
        out["ema_steps"] += steps if u % every(cfg.algo.critic.target_network_frequency) == 0 else 0
        if algo == "sac_ae":
            out["actor_steps"] = out.get("actor_steps", 0) + (steps if u % every(cfg.algo.actor.network_frequency)
                                                              == 0 else 0)
            out["decoder_steps"] = out.get("decoder_steps", 0) + (steps if u % every(cfg.algo.decoder.update_freq)
                                                                  == 0 else 0)
    return out


def _serve_stateless(model, frames):
    """RUN_REQUESTS lockstep batches of RUN_CLIENTS rows through a fresh
    gateway: the served actions ``[T, C, A]`` and the status."""
    import numpy as np

    from sheeprl_tpu_torch.serve import ServeGateway

    steps, clients = next(iter(frames.values())).shape[:2]
    gateway = ServeGateway(model, max_batch=clients, deadline_s=60.0, seed=SEED)
    try:
        ids = [gateway.client(f"client{c}").client_id for c in range(clients)]
        actions = []
        for t in range(steps):
            tickets = [gateway.batcher.submit(cid, {k: v[t, c] for k, v in frames.items()}, reset=t == 0)
                       for c, cid in enumerate(ids)]
            actions.append([np.asarray(gateway.batcher.wait(tk, timeout=120.0)[0]).reshape(-1) for tk in tickets])
        if not gateway.drain(timeout=60.0):
            raise AssertionError("gateway did not drain")
        return np.asarray(actions), gateway.status()
    finally:
        gateway.close()


def phase_run_sac(card: str, name: str):
    """A SAC-family run through the CLI (``SAC_RUN_SPECS``) on
    walker_stand_in at the preset's width, checkpointed: its counters
    against the loop's arithmetic (``_sac_run_predicted``: the catch-up burst,
    G a update, the EMA, actor and decoder cadences), its steps replayed from
    graphs, 0 cell launches, its checkpoint valid to every crc32 and f32,
    then the evaluation command (SAC_EVAL_EPISODES episodes) and the gateway:
    the served actions equal to the evaluation policy's greedy actions on
    the same observations."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ckpt import read_checkpoint, validate_checkpoint
    from sheeprl_tpu_torch.evals.service import _builder_for, probe_spaces
    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.serve.model import load_gateway_model
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    algo, args = SAC_RUN_SPECS[name]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sac_") as root:
        torch.cuda.reset_peak_memory_stats()
        ops.hafner_cell_launches.reset()
        ops.hafner_sequence_launches.reset()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            result, wall = _run_once(root, name, args)
        launches = {"hafner_cell": ops.hafner_cell_launches.count, "hafner_sequence": ops.hafner_sequence_launches.count}
        peak = torch.cuda.max_memory_allocated()
        busy_us, _found = trace_summary(prof, ())
        cfg, _log_dir = cli.load_run_config(result["checkpoint"])
        want = _sac_run_predicted(algo, cfg)
        got = {k: result.get(k, 0) for k in want if k != "train_calls"}
        if got != {k: v for k, v in want.items() if k != "train_calls"}:
            raise AssertionError(f"{name}: the run's counters {got}, the loop's arithmetic {want}")
        graphs = result["graphs"]
        expect = {"train": want["train_calls"], "act": want["player_steps"]}
        for part, calls in expect.items():
            g = graphs[part]
            if (g["eager_calls"], g["replays"], g["captured"]) != (min(calls, WARMUP_CALLS),
                                                                    max(calls - WARMUP_CALLS, 0),
                                                                    int(calls > WARMUP_CALLS)):
                raise AssertionError(f"{name}: the {part} steps ran as {g} for {calls} calls")
        if launches["hafner_cell"] or launches["hafner_sequence"]:
            raise AssertionError(f"{name}: the run launched {launches}")
        ckpt = result["checkpoint"]
        manifest = validate_checkpoint(ckpt, deep=True)
        state = read_checkpoint(ckpt, with_rb=False)
        if not {"agent", "opt_states", "update", "batch_size", "last_log", "last_checkpoint"} <= set(state):
            raise AssertionError(f"{name}: the checkpoint holds {sorted(state)}")
        f32 = _f32_parameters(ckpt)

        ops.hafner_cell_launches.reset()
        t0 = time.perf_counter()
        evaluation = cli.evaluation([f"checkpoint_path={ckpt}", f"eval.episodes={SAC_EVAL_EPISODES}",
                                     f"eval.seed0={EVAL_SEED0}", f"eval.registry_dir={root}/registry"])
        eval_wall = time.perf_counter() - t0
        if evaluation["n"] != SAC_EVAL_EPISODES or not np.isfinite(evaluation["returns"]).all():
            raise AssertionError(f"{name}: the evaluation scored {evaluation}")
        model, cfg, observation_space, action_space = load_gateway_model(ckpt, device="cuda")
        rng = np.random.RandomState(SEED)
        frames = {k: rng.randint(0, 256, (RUN_REQUESTS, RUN_CLIENTS) + s.shape).astype(np.uint8)
                  if s.dtype == np.uint8 else rng.randn(RUN_REQUESTS, RUN_CLIENTS, *s.shape).astype(np.float32)
                  for k, s in observation_space.items()}
        actions, status = _serve_stateless(model, frames)
        policy = _builder_for(algo)(None, cfg, state, observation_space, action_space, device="cuda")
        greedy = np.stack([policy.act({k: v[t] for k, v in frames.items()}, None, None)[0]
                           for t in range(RUN_REQUESTS)])
        served_err = float(np.abs(actions - greedy).max())
        if status["failed_requests"] or served_err != 0.0 or np.abs(actions).max() > 1.0:
            raise AssertionError(f"{name}: served actions differ from the evaluation policy's by {served_err}")
        if ops.hafner_cell_launches.count:
            raise AssertionError(f"{name}: the evaluation or the gateway launched hafner_cell")
        del model, policy
        torch.cuda.empty_cache()
    line = {"run_args": list(args), **{k: result[k] for k in ("updates", "policy_steps", "player_steps",
                                                               "random_steps", "gradient_steps", "ema_steps")},
            "predicted": want, "graphs": graphs, "wall_s": wall, "policy_steps_per_s": result["policy_steps"] / wall,
            "gradient_steps_per_s": result["gradient_steps"] / max(result["seconds"]["sample_and_train"], 1e-9),
            "seconds": result["seconds"], "checkpoint_bytes": sum(manifest["files"].values()),
            "checkpoint_parameters": f32, "evaluation": {k: evaluation[k] for k in ("n", "returns", "mean")},
            "evaluation_wall_s": eval_wall, "served_requests": status["requests"],
            "served_vs_eval_policy_max_abs_err": served_err, "hafner_cell_launches": launches["hafner_cell"],
            "peak_device_memory_bytes": peak, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall, "rates_under_profiler": True, "card": card}
    for k in ("actor_steps", "decoder_steps"):
        if k in result:
            line[k] = result[k]
    print(f"[{name}] " + json.dumps(line), flush=True)
    return launches


#: the Pendulum run's traced window: updates PENDULUM_WINDOW[0] up to PENDULUM_WINDOW[1], each one engine burst and one
#: gradient step (a trace of all 8,192 updates takes longer to stop than the run takes)
PENDULUM_WINDOW = (4000, 4500)


def phase_run_sac_pendulum(card: str):
    """``exp=sac env.backend=jax env.id=Pendulum-v1`` at test_sac_learns_pendulum's
    settings (RUN_PENDULUM_ARGS) on the port's own Pendulum: the rollout
    engine's bursts captured and replayed, the transitions in the device
    ring, sampled there. It passes on that test's criterion: more than 30
    episodes, the last 10 episodes' mean return above -700 and 300 above the
    first 10's. The run is untraced but for PENDULUM_WINDOW's updates,
    whose device busy time over their wall time gives the idle share."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.envs.rollout import engine as engine_module
    from sheeprl_tpu_torch.kernels import ops

    collect = engine_module.RolloutEngine.collect
    window = {"bursts": 0}

    def traced_collect(self, *args, **kwargs):
        if window["bursts"] == PENDULUM_WINDOW[0]:
            torch.cuda.synchronize()
            window["prof"] = profile(activities=[ProfilerActivity.CUDA])
            window["prof"].__enter__()
            window["t0"] = time.perf_counter()
        if window["bursts"] == PENDULUM_WINDOW[1]:
            torch.cuda.synchronize()
            window["wall_s"] = time.perf_counter() - window["t0"]
            window["prof"].__exit__(None, None, None)
        window["bursts"] += 1
        return collect(self, *args, **kwargs)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pendulum_") as root:
        ops.hafner_cell_launches.reset()
        ops.hafner_sequence_launches.reset()
        torch.cuda.reset_peak_memory_stats()
        engine_module.RolloutEngine.collect = traced_collect
        try:
            result, wall = _run_once(root, "run_sac_pendulum", RUN_PENDULUM_ARGS)
        finally:
            engine_module.RolloutEngine.collect = collect
        launches = {"hafner_cell": ops.hafner_cell_launches.count, "hafner_sequence": ops.hafner_sequence_launches.count}
    busy_us, _found = trace_summary(window["prof"], ())
    returns = result["episode_returns"]
    early, late = float(np.mean(returns[:10])), float(np.mean(returns[-10:]))
    engine = result["engine"]
    window_updates = PENDULUM_WINDOW[1] - PENDULUM_WINDOW[0]
    line = {"run_args": list(RUN_PENDULUM_ARGS), "episodes": len(returns), "early_mean_return": early,
            "late_mean_return": late, "criterion": "episodes > 30, late > -700, late > early + 300",
            "policy_steps": result["policy_steps"], "gradient_steps": result["gradient_steps"], "wall_s": wall,
            "policy_steps_per_s": result["policy_steps"] / wall,
            "gradient_steps_per_s": result["gradient_steps"] / max(result["seconds"]["sample_and_train"], 1e-9),
            "seconds": result["seconds"], "engine": engine, "graphs": result["graphs"],
            "hafner_cell_launches": launches["hafner_cell"], "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
            "traced_window_updates": list(PENDULUM_WINDOW), "window_ms_per_update": 1e3 * window["wall_s"] / window_updates,
            "window_device_busy_ms_per_update": busy_us / 1e3 / window_updates,
            "device_idle_share": 1.0 - busy_us / 1e6 / window["wall_s"], "rates_under_profiler": False, "card": card}
    print("[run_sac_pendulum] " + json.dumps(line), flush=True)
    if not (len(returns) > 30 and late > -700 and late > early + 300):
        raise AssertionError(f"run_sac_pendulum: SAC did not learn the port's Pendulum: {len(returns)} episodes, "
                             f"early {early:.1f}, late {late:.1f}")
    if engine["env_steps"] != 32768 or engine["ring_rows"] != 8192 or launches["hafner_cell"]:
        raise AssertionError(f"run_sac_pendulum: engine {engine}, launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# the on-policy family (PPO, A2C, PPO-recurrent)
# ---------------------------------------------------------------------------

# the trainers at their presets' widths and update shapes: PPO on its pixel path (cnn_keys.encoder=[rgb]: NatureCNN
# over 3 x 64 x 64 frames, cnn_features_dim 512, 6 discrete actions) at exp=ppo's rollout of 128 steps x 4 envs, batch
# 64, 10 epochs (80 minibatch steps an update); A2C's CartPole preset (64 x 2 relu, 5 steps x 4 envs, one minibatch
# step of 20 samples); PPO-recurrent's CartPole preset (dense 128 with LayerNorm, LSTM 64; 256 steps x 16 envs in
# sequences of 8, 4 batches of 128 sequences, 4 epochs: 16 minibatch steps of 1,024 steps an update)
ONPOLICY_TRAINERS = {
    "ppo": dict(exp="ppo", overrides=("cnn_keys.encoder=[rgb]", "mlp_keys.encoder=[]"), obs={"rgb": (3, 64, 64)},
                actions=6),
    "a2c": dict(exp="a2c", overrides=(), obs={"state": (4,)}, actions=2),
    "ppo_recurrent": dict(exp="ppo_recurrent", overrides=(), obs={"state": (4,)}, actions=2),
}
# the card's update against the CPU's updates in float32 and float64: one epoch over ONPOLICY_CPU_SAMPLES rows (PPO: 2
# minibatches of 64 frames; A2C: the preset's 20; PPO-recurrent: 4 minibatches of 8 sequences) at lr 0, so that every
# step reads the same weights (an Adam step turns a rounding-sized gradient's sign into +-lr)
ONPOLICY_CPU_SAMPLES = {"ppo": 128, "a2c": 20, "ppo_recurrent": 32}
ONPOLICY_TIMED_UPDATES = {"ppo": 5, "a2c": 50, "ppo_recurrent": 5}
ONPOLICY_GRAPHED_UPDATES = 2
# the JAX learning tests' own overrides, lengths and seeds (tests/test_algos/test_learning.py:20-60, 108-149,
# 151-194) through the port's CLI on cartpole_stand_in (the port's device CartPole on the CPU in float64, CartPole-v1's
# spaces, seeding and time limit; the card has no gymnasium); a checkpoint at the last update (save_last) for the
# evaluation and the gateway, which changes nothing the run learns. The criteria: more than 50 episodes, the last 10's
# mean return above the limit and above the factor times the first 10's
_ONPOLICY_RUN_COMMON = ("env.wrapper._target_=chip_smoke.cartpole_stand_in", "env.sync_env=True",
                        "env.capture_video=False", "fabric.devices=1", "metric.log_level=1", "metric.log_every=100000",
                        "buffer.memmap=False", "checkpoint.save_last=True", "checkpoint.every=100000000",
                        "algo.run_test=False")
ONPOLICY_RUN_SPECS = {
    "run_ppo_cartpole": ("ppo", ("exp=ppo", "env=gym", "env.id=CartPole-v1", "total_steps=40960",
                                 "algo.rollout_steps=64", "per_rank_batch_size=64", "env.num_envs=8",
                                 "algo.anneal_lr=True", "seed=3"), (150.0, 3.0)),
    # seed 2, not the JAX test's 0: the seeds were picked against JAX's PRNG, and the card's run at seed 0 (its
    # CUDA generator's draws) reaches a last-10 mean of 60.6; on the card seeds 1-4 pass, on this repository's CPU
    # table (gymnasium's CartPole) the port passes 5 of seeds 0-4 and the JAX package 3 (PERF.md's seed table)
    "run_a2c_cartpole": ("a2c", ("exp=a2c", "total_steps=40000", "env.num_envs=8", "seed=2"), (80.0, 2.0)),
    "run_ppo_recurrent_cartpole": ("ppo_recurrent", ("exp=ppo_recurrent", "env=gym", "env.id=CartPole-v1",
                                                     "total_steps=49152", "env.num_envs=8", "algo.rollout_steps=128",
                                                     "per_rank_sequence_length=8", "per_rank_batch_size=32",
                                                     "seed=3"), (60.0, 3.0)),
}
# each run's traced window: the updates ONPOLICY_WINDOW[name] (first, end), their rollouts included
ONPOLICY_WINDOW = {"run_ppo_cartpole": (40, 50), "run_a2c_cartpole": (500, 600), "run_ppo_recurrent_cartpole": (24, 32)}
ONPOLICY_EVAL_EPISODES = 4


def cartpole_stand_in(id="CartPole-v1", render_mode=None, **_):
    """``CartPole-v1`` for the card's runs (its machine has no gymnasium),
    made by ``env=gym``'s config (``env.wrapper._target_``) with
    ``gymnasium.make``'s arguments: one env on the Python plane over the
    port's ``device_envs.CartPole`` on the CPU in float64 (held against
    gymnasium's CartPole at atol 1e-6, tests/test_torch_rollout.py), with
    CartPole-v1's spaces, its reset draws (``uniform(-0.05, 0.05, 4)`` from
    ``np.random.default_rng(seed)``, as gymnasium seeds it), its 500-step
    time limit and its spec id (the velocity mask reads it)."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.rollout.device_envs import CartPole
    from sheeprl_tpu_torch.envs.wrappers import Env

    if id != "CartPole-v1":
        raise ValueError(f"the CartPole stand-in is CartPole-v1 only, got {id}")

    class CartPoleStandIn(Env):
        spec = SimpleNamespace(id="CartPole-v1", max_episode_steps=CartPole.max_episode_steps)

        def __init__(self):
            self._env = CartPole(1, "cpu")
            self.observation_space = self._env.observation_space["state"]
            self.action_space = spaces.Discrete(2)
            self._rng = np.random.default_rng()
            self._state = None

        def reset(self, *, seed=None, options=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            phys = torch.from_numpy(self._rng.uniform(low=-0.05, high=0.05, size=(1, 4)))
            self._state = {"phys": phys, "elapsed": torch.zeros(1, dtype=torch.int64)}
            return phys[0].float().numpy(), {}

        def step(self, action):
            a = np.asarray(action)
            if a.size != 1 or int(a.reshape(())) not in (0, 1):
                raise ValueError(f"the CartPole stand-in got an action outside Discrete(2): {action}")
            self._state, obs, reward, terminated, truncated = self._env.step(
                self._state, torch.tensor([[float(a.reshape(()))]]))
            return obs[0].numpy(), float(reward[0]), bool(terminated[0]), bool(truncated[0]), {}

    return CartPoleStandIn()


def _onpolicy_family(name: str):
    from sheeprl_tpu_torch.algos.a2c.a2c import A2C
    from sheeprl_tpu_torch.algos.ppo.ppo import PPO
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import RecurrentPPO

    return {"ppo": PPO, "a2c": A2C, "ppo_recurrent": RecurrentPPO}[name]


def onpolicy_trainer(name: str, device, seed: int = SEED, n_samples=None, **overrides):
    """``(cfg, agent, program, data, perms)``: the preset's agent from seeded
    weights (made on the CPU, then moved), its optimizer and update program
    over ``n_samples`` rows (the preset's update by default), one seeded
    synthetic rollout in the update's layout (flat rows; PPO-recurrent's
    sequences with their initial states) and the update's permutations."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import build_optimizer
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent as build_recurrent_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces

    spec = ONPOLICY_TRAINERS[name]
    cfg = compose(overrides=[f"exp={spec['exp']}", *spec["overrides"]] + [f"{k}={v}" for k, v in overrides.items()])
    observation_space = spaces.Dict({k: spaces.Box(0, 255, s, np.uint8) if len(s) == 3
                                     else spaces.Box(-np.inf, np.inf, s, np.float32) for k, s in spec["obs"].items()})
    cnn_keys, mlp_keys = list(cfg.cnn_keys.encoder), list(cfg.mlp_keys.encoder)
    A = int(spec["actions"])
    build = build_recurrent_agent if name == "ppo_recurrent" else build_agent
    agent = build(cfg, (A,), False, cnn_keys, mlp_keys, observation_space, torch.Generator().manual_seed(seed),
                  device=device)
    family = _onpolicy_family(name)
    n = int(n_samples or family.samples(cfg))
    run = SimpleNamespace(actions_dim=(A,), is_continuous=False, cnn_keys=cnn_keys, obs_keys=mlp_keys + cnn_keys,
                          generator=torch.Generator(device=device).manual_seed(seed))
    program = family.make_program(cfg, agent, build_optimizer(cfg, agent), run, n, device)
    rng = np.random.RandomState(seed)
    lead = (int(cfg.per_rank_sequence_length), n) if name == "ppo_recurrent" else (n,)
    data = {k: rng.randint(0, 256, lead + s).astype(np.uint8) if len(s) == 3 else rng.randn(*lead, *s).astype(np.float32)
            for k, s in spec["obs"].items()}
    data["actions"] = np.eye(A, dtype=np.float32)[rng.randint(0, A, lead)]
    data["logprobs"] = (np.log(1.0 / A) + 0.1 * rng.randn(*lead, 1)).astype(np.float32)
    for k in ("values", "returns", "advantages"):
        data[k] = rng.randn(*lead, 1).astype(np.float32)
    if name == "a2c":
        data.pop("logprobs")
        data.pop("values")
    if name == "ppo_recurrent":
        data["is_first"] = (rng.uniform(size=lead + (1,)) < 0.05).astype(np.float32)
        data["prev_actions"] = data["actions"][[0] + list(range(lead[0] - 1))] * (1.0 - data["is_first"])
        hidden = int(cfg.algo.rnn.lstm.hidden_size)
        data["hc_c"], data["hc_h"] = (0.1 * rng.randn(n, hidden).astype(np.float32) for _ in range(2))
    perms = [np.random.RandomState(seed + 1 + e).permutation(n) for e in range(program.epochs)]
    return cfg, agent, program, data, perms


def _onpolicy_scalars(cfg):
    return [float(cfg.algo.get("clip_coef", 0.0)), float(cfg.algo.get("ent_coef", 0.0))]


def _onpolicy_card_against_cpu(name: str) -> dict:
    """One epoch over ONPOLICY_CPU_SAMPLES rows of the preset's update on the
    card (float32, TF32 off) and on the CPU in float32 and float64, from the
    same weights, rollout and permutation, at lr 0. Held as the SAC phases
    hold theirs: each loss within TOL_TRAIN_LOSS and the gradients' norm (the
    first moment after the epoch: a fixed weighting of its minibatches'
    gradients) within TOL_TRAIN_GRAD, relative, of the CPU's float32 update
    or of its float64 one; both gaps reported, and the first moment's
    relative L2 distance to the float64 update."""
    import math

    import torch

    from sheeprl_tpu_torch.kernels import ops

    metrics, moments, launches = {}, {}, 0
    for side in ("cpu64", "cpu32", "cuda"):
        device = "cuda" if side == "cuda" else "cpu"
        cfg, agent, program, data, perms = onpolicy_trainer(name, device, n_samples=ONPOLICY_CPU_SAMPLES[name],
                                                            **{"algo.optimizer.lr": 0.0, "algo.update_epochs": 1})
        if side == "cpu64":
            agent.double()
            for per_param in program.optimizer.state.values():
                for k in per_param:
                    per_param[k] = per_param[k].double()
            for p in agent.parameters():
                p.grad = torch.zeros_like(p)
            program._params = list(agent.parameters())
            program.acc = program.acc.double()
            data = {k: v.astype("float64") if v.dtype.kind == "f" else v for k, v in data.items()}
        before = ops.hafner_cell_launches.count + ops.hafner_sequence_launches.count
        out = program.update(data, _onpolicy_scalars(cfg), perms=perms)
        metrics[side] = out.double().cpu().tolist()
        moments[side] = [program.optimizer.state[p]["exp_avg"].detach().double().cpu() for p in agent.parameters()]
        if side == "cuda":
            launches = ops.hafner_cell_launches.count + ops.hafner_sequence_launches.count - before
        del agent, program
    torch.cuda.empty_cache()

    def norm(tensors):
        return math.sqrt(sum(float((t ** 2).sum()) for t in tensors))

    def gaps(side, ref):
        names = ("policy", "value", "entropy")
        return {
            "loss_rel_diff": {k: abs(g - r) / max(abs(r), 1e-6) for k, g, r in zip(names, metrics[side], metrics[ref])},
            "grad_norm_rel_diff": abs(norm(moments[side]) - norm(moments[ref])) / norm(moments[ref]),
            "grad_rel_l2_distance": norm([g - r for g, r in zip(moments[side], moments[ref])]) / norm(moments[ref]),
        }

    against32, against64, cpu32 = gaps("cuda", "cpu32"), gaps("cuda", "cpu64"), gaps("cpu32", "cpu64")
    outside = [f"loss:{k}" for k in against32["loss_rel_diff"]
               if not min(against32["loss_rel_diff"][k], against64["loss_rel_diff"][k]) <= TOL_TRAIN_LOSS]
    if not min(against32["grad_norm_rel_diff"], against64["grad_norm_rel_diff"]) <= TOL_TRAIN_GRAD:
        outside.append("grad_norm")
    return {"card": metrics["cuda"], "cpu32": metrics["cpu32"], "cpu64": metrics["cpu64"],
            "card_against_cpu32": against32, "card_against_cpu64": against64, "cpu32_against_cpu64": cpu32,
            "limits": [TOL_TRAIN_LOSS, TOL_TRAIN_GRAD], "outside": outside, "kernel_launches": launches}


def _onpolicy_graphed_against_eager(name: str) -> dict:
    """Full-size updates from one seed, at least ONPOLICY_GRAPHED_UPDATES and
    GRAPH_STEPS minibatch steps, eager (every minibatch step called
    directly) and graphed (the capture's eager warm-up calls, the capture,
    replays), at the same permutations: each update's losses and the final
    parameters."""
    import torch

    runs = {}
    for mode in ("eager", "graphed"):
        cfg, agent, program, data, perms = onpolicy_trainer(name, "cuda")
        steps = program.epochs * program.n_minibatches
        updates = max(ONPOLICY_GRAPHED_UPDATES, -(-GRAPH_STEPS // steps))
        out = [program.update(data, _onpolicy_scalars(cfg), perms=perms, eager=mode == "eager").cpu()
               for _ in range(updates)]
        runs[mode] = {"metrics": [dict(enumerate(o.tolist())) for o in out],
                      "params": {k: v.detach().cpu().clone() for k, v in agent.named_parameters()},
                      "graph": {"eager_calls": program.step.eager_calls, "replays": program.step.replays,
                                "captured": program.step.graph is not None},
                      "steps": updates * steps}
        del agent, program
    torch.cuda.empty_cache()
    return {**_steps_diff(runs["graphed"], runs["eager"]), "graph": runs["graphed"]["graph"],
            "steps": runs["graphed"]["steps"]}


def phase_train_onpolicy(card: str, name: str):
    """PPO's, A2C's or PPO-recurrent's update at the preset's full width and
    update shape (``ONPOLICY_TRAINERS``). No TPU kernel is on their path
    (flax Dense, LayerNorm, Conv and ``nn.OptimizedLSTMCell``), so the
    checks are the card's update against the port's own CPU update in
    float32 or float64 (``_onpolicy_card_against_cpu``; the CPU tests hold
    that update against JAX), updates graphed against eager with cuDNN
    deterministic, and 0 ``hafner_cell`` and ``hafner_sequence`` launches;
    then ONPOLICY_TIMED_UPDATES graphed updates (ms an update, its data
    copied in; ms a minibatch step, replays alone), then one profiled
    (device busy, idle share, top operations), and the peak memory."""
    import math

    import torch

    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.tools.bench_dreamer import profile_steps
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    tag = f"train_{name}"
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        against_cpu = _onpolicy_card_against_cpu(name)
        torch.backends.cudnn.deterministic = True
        graphed = _onpolicy_graphed_against_eager(name)
        torch.backends.cudnn.deterministic = prev[2]
        ops.hafner_cell_launches.reset()
        ops.hafner_sequence_launches.reset()
        torch.cuda.reset_peak_memory_stats()
        cfg, agent, program, data, perms = onpolicy_trainer(name, "cuda")
        scalars = _onpolicy_scalars(cfg)
        program.update(data, scalars)  # the warm-up calls and the capture
        steps_per_update, batch = program.epochs * program.n_minibatches, program.batch_size
        n = ONPOLICY_TIMED_UPDATES[name]
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            metrics = program.update(data, scalars)
        end.record()
        torch.cuda.synchronize()
        ms_update = start.elapsed_time(end) / n
        start.record()
        for _ in range(steps_per_update * n):
            program.step()
        end.record()
        torch.cuda.synchronize()
        ms_step = start.elapsed_time(end) / (steps_per_update * n)
        profiled = profile_steps(lambda: program.update(data, scalars), 1)
        launches = {"hafner_cell": ops.hafner_cell_launches.count, "hafner_sequence": ops.hafner_sequence_launches.count}
        peak = torch.cuda.max_memory_allocated()
        losses = metrics.cpu().tolist()
        parameters = sum(p.numel() for p in agent.parameters())
        del agent, program
        torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = prev
    line = {"card_vs_cpu": against_cpu, "graphed_vs_eager": graphed, "tol": TOL_GRAPHED,
            "minibatch_steps_per_update": steps_per_update, "minibatch_rows": batch,
            "parameters": parameters, "ms_per_update_graphed": ms_update, "ms_per_minibatch_step_graphed": ms_step,
            "profiled_update": profiled, "last_losses": losses, "peak_device_memory_bytes": peak,
            "launches": launches, "card": card}
    print(f"[{tag}] " + json.dumps(line), flush=True)
    bad = list(against_cpu["outside"]) + [f"card:{i}" for i, v in enumerate(against_cpu["card"]) if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{tag}: the card's update and the CPU's updates disagree on {bad}")
    if not graphed["bit_for_bit"] or graphed["metric_max_rel_err"] > TOL_GRAPHED:
        raise AssertionError(f"{tag}: graphed and eager updates disagree: {graphed}")
    if graphed["graph"] != {"eager_calls": WARMUP_CALLS, "replays": graphed["steps"] - WARMUP_CALLS, "captured": True}:
        raise AssertionError(f"{tag}: the graphed steps ran as {graphed['graph']}")
    if against_cpu["kernel_launches"] or launches["hafner_cell"] or launches["hafner_sequence"]:
        raise AssertionError(f"{tag}: an on-policy update launched a GRU kernel: {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: a loss is not finite: {losses}")
    return launches, {"card_vs_cpu_loss_max_rel_diff": max(
                          min(g, against_cpu["card_against_cpu64"]["loss_rel_diff"][k])
                          for k, g in against_cpu["card_against_cpu32"]["loss_rel_diff"].items()),
                      "card_vs_cpu_grad_norm_rel_diff": min(against_cpu["card_against_cpu32"]["grad_norm_rel_diff"],
                                                            against_cpu["card_against_cpu64"]["grad_norm_rel_diff"]),
                      "graphed_vs_eager_bit_for_bit": graphed["bit_for_bit"],
                      "ms_per_update_graphed": ms_update, "ms_per_minibatch_step_graphed": ms_step,
                      "device_idle_share": profiled["device_idle_share"], "peak_device_memory_bytes": peak}


def _serve_onpolicy(model, cfg, state, observation_space, action_space):
    """RUN_REQUESTS lockstep requests of RUN_CLIENTS clients through a fresh
    gateway (a client's first request resets its rows), and the evaluation
    policy's greedy actions on the same observations (PPO-recurrent's state
    carried from fresh rows); returns the largest difference and the
    gateway's status."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.evals.service import _builder_for, fresh_state

    rng = np.random.RandomState(SEED)
    frames = {k: (0.5 * rng.randn(RUN_REQUESTS, RUN_CLIENTS, *s.shape)).astype(np.float32)
              for k, s in observation_space.items()}
    served, status = _serve_stateless(model, frames)
    policy = _builder_for(str(cfg.algo.name))(None, cfg, state, observation_space, action_space, device="cuda")
    rows = None if policy.init_state is None else fresh_state(policy.init_state, RUN_CLIENTS)
    greedy = []
    for t in range(RUN_REQUESTS):
        actions, rows = policy.act({k: v[t] for k, v in frames.items()}, rows, torch.Generator(device="cuda"))
        greedy.append(np.asarray(actions).reshape(RUN_CLIENTS, -1))
    return float(np.abs(served.reshape(np.shape(greedy)) - np.asarray(greedy)).max()), status


def phase_run_onpolicy(card: str, name: str):
    """A JAX learning test's config through the port's CLI on
    cartpole_stand_in (``ONPOLICY_RUN_SPECS``): it passes that test's
    criterion, unchanged; its minibatch and acting steps replayed from
    graphs, 0 ``hafner_cell`` and ``hafner_sequence`` launches, its checkpoint
    valid to every crc32; the evaluation command (ONPOLICY_EVAL_EPISODES
    episodes) and the gateway: the served actions equal to the evaluation
    policy's greedy actions on the same observations. The run is untraced
    but for ONPOLICY_WINDOW's updates (their rollouts too), whose device busy
    time over their wall time gives the idle share."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.ppo import ppo as ppo_module
    from sheeprl_tpu_torch.ckpt import read_checkpoint, validate_checkpoint
    from sheeprl_tpu_torch.evals.service import probe_spaces
    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.serve.model import load_gateway_model
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    algo, args, (limit, factor) = ONPOLICY_RUN_SPECS[name]
    args = _ONPOLICY_RUN_COMMON + args
    first, last = ONPOLICY_WINDOW[name]
    update = ppo_module.UpdateProgram.update
    window = {"updates": 0}

    def traced_update(self, *a, **kw):
        out = update(self, *a, **kw)
        window["updates"] += 1
        if window["updates"] in (first, last):
            torch.cuda.synchronize()
            if window["updates"] == first:
                window["prof"] = profile(activities=[ProfilerActivity.CUDA])
                window["prof"].__enter__()
                window["t0"] = time.perf_counter()
            else:
                window["wall_s"] = time.perf_counter() - window["t0"]
                window["prof"].__exit__(None, None, None)
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_onpolicy_") as root:
        ops.hafner_cell_launches.reset()
        ops.hafner_sequence_launches.reset()
        torch.cuda.reset_peak_memory_stats()
        printed = io.StringIO()
        ppo_module.UpdateProgram.update = traced_update
        try:
            with contextlib.redirect_stdout(printed):
                result, wall = _run_once(root, name, args)
        finally:
            ppo_module.UpdateProgram.update = update
        launches = {"hafner_cell": ops.hafner_cell_launches.count, "hafner_sequence": ops.hafner_sequence_launches.count}
        peak = torch.cuda.max_memory_allocated()
        busy_us, _found = trace_summary(window["prof"], ())
        rewards = [float(line.rsplit("=", 1)[-1]) for line in printed.getvalue().splitlines() if "reward_env" in line]
        returns = result["episode_returns"]
        early, late = float(np.mean(returns[:10])), float(np.mean(returns[-10:]))
        passed = len(returns) > 50 and late > limit and late > factor * early
        graphs = result["graphs"]
        expect = {"train": result["gradient_steps"], "act": result["acting_steps"], "gae": result["updates"]}
        for part, calls in expect.items():
            g = graphs[part]
            if (g["eager_calls"], g["replays"], g["captured"]) != (min(calls, WARMUP_CALLS),
                                                                    max(calls - WARMUP_CALLS, 0),
                                                                    int(calls > WARMUP_CALLS)):
                raise AssertionError(f"{name}: the {part} steps ran as {g} for {calls} calls")
        ckpt = result["checkpoint"]
        manifest = validate_checkpoint(ckpt, deep=True)
        state = read_checkpoint(ckpt, with_rb=False)
        t0 = time.perf_counter()
        evaluation = cli.evaluation([f"checkpoint_path={ckpt}", f"eval.episodes={ONPOLICY_EVAL_EPISODES}",
                                     f"eval.seed0={EVAL_SEED0}", f"eval.registry_dir={root}/registry"])
        eval_wall = time.perf_counter() - t0
        model, cfg, observation_space, action_space = load_gateway_model(ckpt, device="cuda")
        served_err, status = _serve_onpolicy(model, cfg, state, observation_space, action_space)
        launches_after = {"hafner_cell": ops.hafner_cell_launches.count,
                          "hafner_sequence": ops.hafner_sequence_launches.count}
        del model
        torch.cuda.empty_cache()
    updates = window["updates"]
    line = {"run_args": list(args), "episodes": len(returns), "early_mean_return": early, "late_mean_return": late,
            "criterion": f"episodes > 50, late > {limit}, late > {factor} x early", "passed": passed,
            "printed_episodes": len(rewards), **{k: result[k] for k in ("updates", "policy_steps", "acting_steps",
                                                                         "gradient_steps")},
            "graphs": graphs, "wall_s": wall, "policy_steps_per_s": result["policy_steps"] / wall,
            "gradient_steps_per_s": result["gradient_steps"] / max(result["seconds"]["train"], 1e-9),
            "seconds": result["seconds"], "checkpoint_bytes": sum(manifest["files"].values()),
            "evaluation": {k: evaluation[k] for k in ("n", "returns", "mean")}, "evaluation_wall_s": eval_wall,
            "served_requests": status["requests"], "served_vs_eval_policy_max_abs_err": served_err,
            "launches": launches_after, "peak_device_memory_bytes": peak,
            "traced_window_updates": [first, last], "window_ms_per_update": 1e3 * window["wall_s"] / (last - first),
            "window_device_busy_ms_per_update": busy_us / 1e3 / (last - first),
            "device_idle_share": 1.0 - busy_us / 1e6 / window["wall_s"], "rates_under_profiler": False,
            "probe_observation_space": {k: list(s.shape) for k, s in probe_spaces(cfg)[0].items()}, "card": card}
    print(f"[{name}] " + json.dumps(line), flush=True)
    if rewards != returns:
        raise AssertionError(f"{name}: the printed episodes ({len(rewards)}) are not the run's ({len(returns)})")
    if not passed:
        raise AssertionError(f"{name}: {algo} did not learn the CartPole stand-in: {len(returns)} episodes, "
                             f"early {early:.1f}, late {late:.1f} ({line['criterion']})")
    if any(launches.values()) or any(launches_after.values()):
        raise AssertionError(f"{name}: an on-policy path launched a GRU kernel: {launches} {launches_after}")
    if evaluation["n"] != ONPOLICY_EVAL_EPISODES or not np.isfinite(evaluation["returns"]).all():
        raise AssertionError(f"{name}: the evaluation scored {evaluation}")
    if status["failed_requests"] or served_err != 0.0:
        raise AssertionError(f"{name}: served actions differ from the evaluation policy's by {served_err}")
    if updates != result["updates"] or not {"params", "opt_state", "update", "last_log", "last_checkpoint"} <= set(state):
        raise AssertionError(f"{name}: {updates} traced updates of {result['updates']}; checkpoint {sorted(state)}")
    if name == "run_ppo_cartpole":
        line = _profiled_onpolicy_run(args)
        print(f"[{name}_profiler] " + json.dumps(line), flush=True)
    return launches_after


def _profiled_onpolicy_run(args) -> dict:
    """One update of the run's config with ``metric.profiler=<dir>``: the
    port's whole-run ``torch.profiler`` trace, which must hold CUDA kernel
    events (and the update's minibatch steps attributed by the parser)."""
    import tempfile

    from sheeprl_tpu_torch.obs.prof.trace import load_trace, summarize_events

    with tempfile.TemporaryDirectory(prefix="chip_smoke_profiler_") as root:
        trace_dir = os.path.join(root, "trace")
        t0 = time.perf_counter()
        # one update of 2 envs x 8 steps: the trace stays small (a few MB) and quick to read
        _run_once(root, "profiled", tuple(args) + ("dry_run=True", "env.num_envs=2", "algo.rollout_steps=8",
                                                   "per_rank_batch_size=8", f"metric.profiler={trace_dir}"))
        wall = time.perf_counter() - t0
        path = os.path.join(trace_dir, "trace.json")
        events = load_trace(path)
        kernels = sum(1 for e in events if e[0] == "kernel")
        summary = summarize_events(events)
        line = {"trace_bytes": os.path.getsize(path), "events": len(events), "kernel_events": kernels,
                "source": summary["source"], "modules": {k: m["execs"] for k, m in summary["modules"].items()},
                "wall_s": wall}
    if not kernels or summary["source"] != "device":
        raise AssertionError(f"metric.profiler: the trace holds {kernels} kernel events ({line})")
    return line


# ---------------------------------------------------------------------------
# the actor-learner plane: sac_decoupled and ppo_decoupled (no kernel on their path)
# ---------------------------------------------------------------------------

# test_sac_learns_pendulum's settings (tests/test_algos/test_learning.py:63-105) on pendulum_stand_in, at the
# preset's widths (hidden 256): 4 envs, learning from 1000 policy steps, batch 128, seed 3, through
# exp=sac_decoupled fabric.devices=auto. The thread run and the 1-player process run are cut to
# DECOUPLED_SAC_CUT_STEPS (their final learner state and replay are compared bit for bit: the replay is
# checkpointed and sampled on the training thread, buffer.prefetch=False; the thread run's envs are the sync env,
# which the worker pool is bitwise); the 2-player run with two replay shards is the test's length, 32,768 steps, with
# a version of slack (plane.max_policy_lag=1: a player acts on the newest version at least one older than the
# protocol's, so that it never waits for the newest), and passes its criterion. TD priorities run on two players and two shards at
# the cut length, held to their writeback: with them the config misses the criterion in 32,768 steps in the JAX
# package and in the port alike (PERF.md's seed table, tools/learning_seeds.py --algo sac_decoupled_td), neither
# weighting the critic loss by the importance weights
# the 2-player run's flight recorder opens a profiler window of 1 s at its dump; the slow-span trigger armed at any
# span over its running p50 after 1000 observations (a quarter of the run's 4096 updates: training runs by then) makes
# the dump certain and lands its window on the learner's train steps, and one dump a run keeps the window's cost (the
# profiler on the learner's thread, the trace written and parsed beside it) to one second's
DECOUPLED_FLIGHT_CAPTURE_ARGS = ("metric.telemetry.flight.profiler_capture_s=1", "metric.telemetry.flight.max_dumps=1",
                                 "metric.telemetry.flight.slow_span_factor=1", "metric.telemetry.flight.slow_span_min_ms=0",
                                 "metric.telemetry.flight.slow_span_warmup=1000")
_DECOUPLED_SAC_COMMON = ("exp=sac_decoupled", "fabric.devices=auto", "env.wrapper._target_=chip_smoke.pendulum_stand_in",
                         "env.id=Pendulum-v1", "env.capture_video=False", "env.num_envs=4", "env.vectorization=async",
                         "algo.learning_starts=1000", "per_rank_batch_size=128", "metric.log_level=0",
                         "buffer.memmap=False", "checkpoint.every=100000000", "checkpoint.save_last=True",
                         "algo.run_test=False", "seed=3")
DECOUPLED_SAC_CUT_STEPS = 2048
DECOUPLED_SAC_RUNS = {
    "thread": (f"total_steps={DECOUPLED_SAC_CUT_STEPS}", "plane.num_players=0", "buffer.prefetch=False",
               "buffer.checkpoint=True", "env.vectorization=sync"),
    "one_player": (f"total_steps={DECOUPLED_SAC_CUT_STEPS}", "plane.num_players=1", "buffer.prefetch=False",
                   "buffer.checkpoint=True") + TELEMETRY_ARGS,
    "two_players_td": (f"total_steps={DECOUPLED_SAC_CUT_STEPS}", "plane.num_players=2", "replay.shards=2",
                       "replay.strategy=td_priority"),
    "two_players": ("total_steps=32768", "plane.num_players=2", "replay.shards=2",
                    "plane.max_policy_lag=1") + TELEMETRY_ARGS + DECOUPLED_FLIGHT_CAPTURE_ARGS,
}
# each run's traced window: its training bursts (each one update's gradient step) DECOUPLED_SAC_WINDOW[run]
DECOUPLED_SAC_WINDOW = {"thread": (100, 200), "one_player": (100, 200), "two_players_td": (100, 200),
                        "two_players": (4000, 4200)}
# test_ppo_learns_cartpole's config, length and seed (tests/test_algos/test_learning.py:20-60) on
# cartpole_stand_in through exp=ppo_decoupled fabric.devices=auto: 2 player processes of 4 envs on the async pool
RUN_PPO_DECOUPLED_ARGS = ("exp=ppo_decoupled", "fabric.devices=auto", "env.wrapper._target_=chip_smoke.cartpole_stand_in",
                          "env.id=CartPole-v1", "env.capture_video=False", "env.vectorization=async",
                          "plane.num_players=2", "total_steps=40960", "algo.rollout_steps=64", "per_rank_batch_size=64",
                          "env.num_envs=8", "algo.anneal_lr=True", "metric.log_level=0", "buffer.memmap=False",
                          "checkpoint.every=100000000", "checkpoint.save_last=True", "algo.run_test=False", "seed=3")
DECOUPLED_PPO_WINDOW = (40, 50)


def pendulum_stand_in(id="Pendulum-v1", render_mode=None, **_):
    """``Pendulum-v1`` for the card's runs (its machine has no gymnasium),
    made by ``env=gym``'s config (``env.wrapper._target_``) with
    ``gymnasium.make``'s arguments: one env over the port's
    ``device_envs.Pendulum`` on the CPU in float64 (held against gymnasium's
    Pendulum, tests/test_torch_decoupled.py), with Pendulum-v1's spaces, its
    reset draws (θ, θ̇ from ``uniform([-π, -1], [π, 1])`` of
    ``np.random.default_rng(seed)``, as gymnasium seeds it), its 200-step
    time limit and its spec id."""
    import math
    from types import SimpleNamespace

    import numpy as np
    import torch

    from sheeprl_tpu_torch.envs.rollout.device_envs import Pendulum
    from sheeprl_tpu_torch.envs.wrappers import Env

    if id != "Pendulum-v1":
        raise ValueError(f"the Pendulum stand-in is Pendulum-v1 only, got {id}")

    class PendulumStandIn(Env):
        spec = SimpleNamespace(id="Pendulum-v1", max_episode_steps=Pendulum.max_episode_steps)

        def __init__(self):
            self._env = Pendulum(1, "cpu")
            self.observation_space = self._env.observation_space["state"]
            self.action_space = self._env.action_space
            self._rng = np.random.default_rng()
            self._state = None

        def reset(self, *, seed=None, options=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            th, thdot = self._rng.uniform(low=[-math.pi, -1.0], high=[math.pi, 1.0])
            th, thdot = torch.tensor([th], dtype=torch.float64), torch.tensor([thdot], dtype=torch.float64)
            self._state = {"th": th, "thdot": thdot, "elapsed": torch.zeros(1, dtype=torch.int64)}
            return Pendulum._obs(th, thdot)[0].numpy(), {}

        def step(self, action):
            a = torch.as_tensor(np.asarray(action, np.float32).reshape(1, 1))
            self._state, obs, reward, terminated, truncated = self._env.step(self._state, a)
            return obs[0].numpy(), float(reward[0]), bool(terminated[0]), bool(truncated[0]), {}

    return PendulumStandIn()


class _BurstWindow:
    """Traces the calls ``first`` up to ``last`` of a method (patched in by
    :meth:`wrap`): the window's device busy time over its wall time gives a
    run's idle share; ``probe`` runs once at the window's start (the
    compute-apps reading while the players are live)."""

    def __init__(self, first: int, last: int, probe=None):
        self.first, self.last, self.calls, self.probe = first, last, 0, probe
        self.prof = self.wall_s = self.t0 = None
        self.probed = None
        self.claimed = False

    def wrap(self, fn):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from sheeprl_tpu_torch.obs.prof import capture

        def traced(*args, **kwargs):
            if self.calls == self.first:
                if self.probe is not None:
                    self.probed = self.probe()
                # one profiler session a process: a flight recorder's window open on this (the loop's) thread closes
                # first, and this window holds the slot until it ends
                if capture._WINDOW is not None:
                    capture._WINDOW.stop()
                self.claimed = capture.try_begin_capture()
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.calls += 1
            if self.calls == self.last:
                torch.cuda.synchronize()
                self.wall_s = time.perf_counter() - self.t0
                self.prof.__exit__(None, None, None)
                if self.claimed:
                    capture.end_capture()
            return out

        return traced

    def line(self) -> dict:
        if self.wall_s is None:
            raise AssertionError(f"the traced window ({self.first}, {self.last}) was not reached: {self.calls} calls")
        busy_us, _found = trace_summary(self.prof, ())
        n = self.last - self.first
        return {"traced_window_calls": [self.first, self.last], "window_ms_per_call": 1e3 * self.wall_s / n,
                "window_device_busy_ms_per_call": busy_us / 1e3 / n,
                "device_idle_share": 1.0 - busy_us / 1e6 / self.wall_s}


def _compute_apps():
    """``nvidia-smi --query-compute-apps=pid``'s pids (the processes that
    hold a context on the card)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return sorted(int(p) for p in out.stdout.split() if p.strip().isdigit())


def _device_files(pid: int) -> list:
    """The card's device files (``/dev/nvidia*``) that process ``pid`` holds
    open: a process that has initialised CUDA holds the control, UVM and
    device nodes for its life; one that has not holds none."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return []
    found = set()
    for fd in fds:
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue  # closed since the listing
        if target.startswith("/dev/nvidia"):
            found.add(target)
    return sorted(found)


class _PlaneWatch:
    """The process plane's pids while its run is live (``ProcessPlane.start``
    patched), and who holds the card: while the players and their env
    workers run, none of them (``_descendants``) holds one of the card's
    device files open (``_device_files``), and the learner, whose context is
    open, does. Other processes on the card (the lanes) leave the reading
    as it is. nvidia-smi's compute apps are kept beside it: the card's
    machine numbers them in another pid namespace."""

    def __init__(self):
        from sheeprl_tpu_torch.plane import supervisor

        self.supervisor, self.start = supervisor, supervisor.ProcessPlane.start
        self.planes = []
        self.baseline = None

    def __enter__(self):
        import torch

        watch = self

        def start(plane):
            watch.planes.append(plane)
            return watch.start(plane)

        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        self.baseline = _compute_apps()
        self.supervisor.ProcessPlane.start = start
        return self

    def __exit__(self, *exc):
        self.supervisor.ProcessPlane.start = self.start
        return False

    def probe(self) -> dict:
        """With the players live: no player or env worker holds the card,
        the learner does."""
        import multiprocessing as mp

        players = [pid for plane in self.planes for pid in plane.pids()]
        workers = sorted({pid for player in players for pid in _descendants(player)})
        held = {pid: files for pid in players + workers if (files := _device_files(pid))}
        learner = _device_files(os.getpid())
        reading = {"learner_pid": os.getpid(), "learner_device_files": learner, "player_pids": players,
                   "worker_pids": workers, "plane_device_files": held,
                   "learner_apps_before_the_players": self.baseline, "compute_app_pids": _compute_apps(),
                   "children": len(mp.active_children())}
        if not players or not learner or held:
            raise AssertionError(f"a process of the plane holds the card, or the learner does not: {reading}")
        return reading


def _leaves(tree, prefix=""):
    import numpy as np

    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _bitwise_states(a: str, b: str, rows: int) -> dict:
    """Two checkpoints' learner states (agent, optimizers, counters) and their
    replays' first ``rows`` rows, compared bit for bit."""
    import numpy as np

    from sheeprl_tpu_torch.ckpt import read_checkpoint

    la, lb = dict(_leaves(read_checkpoint(a))), dict(_leaves(read_checkpoint(b)))
    if sorted(la) != sorted(lb):
        raise AssertionError(f"the checkpoints hold other leaves: {sorted(set(la) ^ set(lb))}")
    differ = [k for k in la if not np.array_equal(la[k][:rows] if k.startswith("/rb/buffer/") else la[k],
                                                   lb[k][:rows] if k.startswith("/rb/buffer/") else lb[k])]
    if differ:
        raise AssertionError(f"the 1-player process run is not bitwise the thread run: {differ[:8]}")
    return {"leaves": len(la), "replay_rows": rows, "differ": 0}


def _eval_and_serve(name: str, ckpt: str, root: str, algo: str) -> dict:
    """The evaluation command on a decoupled run's checkpoint, and the
    gateway: the served actions equal to the evaluation policy's greedy
    actions on the same observations."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ckpt import read_checkpoint, validate_checkpoint
    from sheeprl_tpu_torch.evals.service import _builder_for
    from sheeprl_tpu_torch.serve.model import load_gateway_model

    manifest = validate_checkpoint(ckpt, deep=True)
    state = read_checkpoint(ckpt, with_rb=False)
    t0 = time.perf_counter()
    evaluation = cli.evaluation([f"checkpoint_path={ckpt}", f"eval.episodes={SAC_EVAL_EPISODES}",
                                 f"eval.seed0={EVAL_SEED0}", f"eval.registry_dir={root}/registry",
                                 "eval.vectorization=sync"])
    eval_wall = time.perf_counter() - t0
    if evaluation["n"] != SAC_EVAL_EPISODES or not np.isfinite(evaluation["returns"]).all():
        raise AssertionError(f"{name}: the evaluation scored {evaluation}")
    model, cfg, observation_space, action_space = load_gateway_model(ckpt, device="cuda")
    rng = np.random.RandomState(SEED)
    frames = {k: (0.5 * rng.randn(RUN_REQUESTS, RUN_CLIENTS, *s.shape)).astype(np.float32)
              for k, s in observation_space.items()}
    served, status = _serve_stateless(model, frames)
    policy = _builder_for(algo)(None, cfg, state, observation_space, action_space, device="cuda")
    greedy = np.stack([np.asarray(policy.act({k: v[t] for k, v in frames.items()}, None, None)[0]).reshape(
        RUN_CLIENTS, -1) for t in range(RUN_REQUESTS)])
    served_err = float(np.abs(served.reshape(greedy.shape) - greedy).max())
    if status["failed_requests"] or served_err != 0.0:
        raise AssertionError(f"{name}: served actions differ from the evaluation policy's by {served_err}")
    del model, policy
    torch.cuda.empty_cache()
    return {"checkpoint_bytes": sum(manifest["files"].values()),
            "evaluation": {k: evaluation[k] for k in ("n", "returns", "mean")}, "evaluation_wall_s": eval_wall,
            "served_requests": status["requests"], "served_vs_eval_policy_max_abs_err": served_err}


def _decoupled_run(root: str, name: str, args, window: "_BurstWindow", patch) -> tuple:
    """One decoupled run through the CLI with ``patch = (owner, method
    name)`` traced over ``window``: ``(result, wall, launches, peak)``."""
    import torch

    from sheeprl_tpu_torch.kernels import ops

    owner, attr = patch
    original = getattr(owner, attr)
    ops.hafner_cell_launches.reset()
    ops.hafner_sequence_launches.reset()
    torch.cuda.reset_peak_memory_stats()
    setattr(owner, attr, window.wrap(original))
    try:
        result, wall = _run_once(root, name, args)
    finally:
        setattr(owner, attr, original)
    launches = {"hafner_cell": ops.hafner_cell_launches.count, "hafner_sequence": ops.hafner_sequence_launches.count}
    return result, wall, launches, torch.cuda.max_memory_allocated()


def _decoupled_line(result, wall: float, window: "_BurstWindow", peak: int, launches: dict) -> dict:
    return {**{k: result[k] for k in ("updates", "policy_steps", "gradient_steps") if k in result},
            "episodes": len(result["episode_returns"]), "wall_s": wall,
            "policy_steps_per_s": result["policy_steps"] / wall, "seconds": result["seconds"],
            "plane_wait_ms_per_update": 1e3 * result["seconds"]["plane_wait"] / max(result["updates"], 1),
            "plane": result["plane"], "graphs": result["graphs"], **window.line(), "probe": window.probed,
            "peak_device_memory_bytes": peak, "launches": launches, "rates_under_profiler": False}


def phase_run_sac_decoupled(card: str):
    """``exp=sac_decoupled fabric.devices=auto`` on pendulum_stand_in at
    test_sac_learns_pendulum's settings (``DECOUPLED_SAC_RUNS``): a thread
    run and a 1-player process run cut to DECOUPLED_SAC_CUT_STEPS, whose
    final learner states and replays must be bitwise equal; a 2-player run
    with two shards and TD priorities at the cut length, whose every
    sampled row's priority is written back; then a 2-player run with two
    shards at the test's length, which passes its criterion (late > -700,
    late > early + 300, more than 30 episodes) and is evaluated and served
    (served equal to evaluated). While the process runs are live no player
    or env worker holds a context on the card; every run launches neither
    kernel. Each run's traced window gives its idle share."""
    import tempfile

    import numpy as np

    from sheeprl_tpu_torch.algos.sac import sac as sac_module
    from sheeprl_tpu_torch.replay import strategies

    lines, launches_by_run, written = {}, {}, []
    update = strategies.TDPriorityStrategy.update_priorities

    def counted(self, rb, t_idx, e_idx, td):
        written.append((id(rb), len(td)))
        return update(self, rb, t_idx, e_idx, td)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sac_decoupled_") as root, _PlaneWatch() as watch:
        results = {}
        strategies.TDPriorityStrategy.update_priorities = counted
        try:
            for run, extra in DECOUPLED_SAC_RUNS.items():
                window = _BurstWindow(*DECOUPLED_SAC_WINDOW[run], probe=watch.probe if run != "thread" else None)
                result, wall, launches, peak = _decoupled_run(root, f"sac_{run}", _DECOUPLED_SAC_COMMON + extra,
                                                              window, (sac_module.StepProgram, "burst"))
                results[run] = result
                launches_by_run[run] = launches
                returns = result["episode_returns"]
                lines[run] = {**_decoupled_line(result, wall, window, peak, launches),
                              "early_mean_return": float(np.mean(returns[:10])),
                              "late_mean_return": float(np.mean(returns[-10:]))}
                if "metric=telemetry" in extra:
                    lines[run]["telemetry"] = _check_decoupled_telemetry(run, result, wall)
                print(f"[run_sac_decoupled_{run}] " + json.dumps(lines[run]), flush=True)
                if any(launches.values()):
                    raise AssertionError(f"run_sac_decoupled {run}: the run launched {launches}")
                exits = result["plane"]["exits"]
                if run != "thread" and (len(exits) != result["plane"]["players"]
                                        or any(e["cuda_initialized"] for e in exits.values())):
                    raise AssertionError(f"run_sac_decoupled {run}: the players' reports {exits}")
        finally:
            strategies.TDPriorityStrategy.update_priorities = update
        rows = DECOUPLED_SAC_CUT_STEPS // 4
        lines["one_player"]["bitwise_vs_thread"] = _bitwise_states(results["thread"]["checkpoint"],
                                                                   results["one_player"]["checkpoint"], rows)
        steps = results["two_players_td"]["gradient_steps"]
        lines["two_players_td"]["priority_rows_written"] = sum(n for _, n in written)
        if sum(n for _, n in written) != 128 * steps or len({rb for rb, _ in written}) != 2:
            raise AssertionError(f"run_sac_decoupled: {sum(n for _, n in written)} priorities written back to "
                                 f"{len({rb for rb, _ in written})} shards for {steps} gradient steps of 128 rows")
        returns = results["two_players"]["episode_returns"]
        early, late = lines["two_players"]["early_mean_return"], lines["two_players"]["late_mean_return"]
        lines["two_players"]["criterion"] = "episodes > 30, late > -700, late > early + 300"
        if not (len(returns) > 30 and late > -700 and late > early + 300):
            raise AssertionError(f"run_sac_decoupled: the 2-player run did not learn the Pendulum stand-in: "
                                 f"{len(returns)} episodes, early {early:.1f}, late {late:.1f}")
        lines["two_players"].update(_eval_and_serve("run_sac_decoupled", results["two_players"]["checkpoint"], root,
                                                    "sac_decoupled"))
    print("[run_sac_decoupled] " + json.dumps({"runs": lines, "card": card}), flush=True)
    return {f"run_sac_decoupled_{run}": counts for run, counts in launches_by_run.items()}


def phase_run_ppo_decoupled(card: str):
    """``exp=ppo_decoupled fabric.devices=auto`` on cartpole_stand_in at
    test_ppo_learns_cartpole's config, length and seed, on two player
    processes of 4 envs each (RUN_PPO_DECOUPLED_ARGS): it passes that test's
    criterion (late > 150, late > 3 x early, more than 50 episodes), is
    evaluated and served (served equal to evaluated); while it is live no
    player or env worker holds a context on the card; neither kernel
    launches. Its traced window (DECOUPLED_PPO_WINDOW's updates) gives the
    idle share."""
    import tempfile

    import numpy as np

    from sheeprl_tpu_torch.algos.ppo import ppo as ppo_module

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ppo_decoupled_") as root, _PlaneWatch() as watch:
        window = _BurstWindow(*DECOUPLED_PPO_WINDOW, probe=watch.probe)
        result, wall, launches, peak = _decoupled_run(root, "ppo_two_players", RUN_PPO_DECOUPLED_ARGS, window,
                                                      (ppo_module.UpdateProgram, "update"))
        line = _decoupled_line(result, wall, window, peak, launches)
        if any(launches.values()):
            raise AssertionError(f"run_ppo_decoupled: the run launched {launches}")
        exits = result["plane"]["exits"]
        if len(exits) != 2 or any(e["cuda_initialized"] for e in exits.values()):
            raise AssertionError(f"run_ppo_decoupled: the players' reports {exits}")
        returns = result["episode_returns"]
        early, late = float(np.mean(returns[:10])), float(np.mean(returns[-10:]))
        line.update({"early_mean_return": early, "late_mean_return": late,
                     "criterion": "episodes > 50, late > 150, late > 3 x early"})
        if not (len(returns) > 50 and late > 150 and late > 3 * early):
            raise AssertionError(f"run_ppo_decoupled: PPO did not learn the CartPole stand-in: {len(returns)} "
                                 f"episodes, early {early:.1f}, late {late:.1f}")
        line.update(_eval_and_serve("run_ppo_decoupled", result["checkpoint"], root, "ppo_decoupled"))
    print("[run_ppo_decoupled] " + json.dumps({"run_args": list(RUN_PPO_DECOUPLED_ARGS), **line, "card": card}),
          flush=True)
    return {"run_ppo_decoupled": launches}


def main_decoupled() -> int:
    """``--decoupled``: the actor-learner plane's phases alone (the kernels
    built first, as the full script builds them); the full script runs them
    in the ``plane`` lane."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sheeprl_tpu_torch.kernels import build

    clock = _PhaseClock()
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build.build_all()
    paths = {}
    paths.update(clock("run_sac_decoupled", phase_run_sac_decoupled, card))
    paths.update(clock("run_ppo_decoupled", phase_run_ppo_decoupled, card))
    print("[telemetry] " + json.dumps(TELEMETRY_CHECKS), flush=True)
    print("[timing] " + json.dumps(clock.line()), flush=True)
    print("[decoupled_paths] " + json.dumps(paths), flush=True)
    return 0


def main_seeds(argv) -> int:
    """``--seeds <run> <seed> ...``: ONPOLICY_RUN_SPECS[run] (or
    ``run_sac_decoupled``: its 2-player, 2-shard run; ``run_sac_decoupled_td``:
    that run with TD priorities, both 32,768 steps) at each
    seed on the card (its checkpoint left out), one JSON line a seed: the
    episodes, the first and last 10's means and whether the run's criterion
    holds. The card's side of the seed tables in PERF.md
    (``tools/learning_seeds.py`` gives the CPU's)."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sheeprl_tpu_torch import cli

    name, seeds = argv[0], [int(s) for s in argv[1:]]
    if name in ("run_sac_decoupled", "run_sac_decoupled_td"):
        run = "two_players" if name == "run_sac_decoupled" else "two_players_td"
        algo, args = "sac_decoupled", _DECOUPLED_SAC_COMMON + DECOUPLED_SAC_RUNS[run] + ("total_steps=32768",)
        passed = lambda n, early, late: n > 30 and late > -700 and late > early + 300  # noqa: E731
    else:
        algo, args, (limit, factor) = ONPOLICY_RUN_SPECS[name]
        args = _ONPOLICY_RUN_COMMON + args
        passed = lambda n, early, late: n > 50 and late > limit and late > factor * early  # noqa: E731
    base = [a for a in args if not a.startswith(("seed=", "checkpoint.save_last="))]
    print(f"[card] {card_line()}", flush=True)
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_seeds_") as root, contextlib.redirect_stdout(io.StringIO()):
            result, wall = _run_once(root, f"seed{seed}", base + [f"seed={seed}", "checkpoint.save_last=False"])
        r = result["episode_returns"]
        early, late = float(np.mean(r[:10])), float(np.mean(r[-10:]))
        print("[seeds] " + json.dumps({"run": name, "algo": algo, "seed": seed, "episodes": len(r), "early": early,
                                        "late": late, "passed": passed(len(r), early, late), "wall_s": wall}),
              flush=True)
    return 0


def main_ppo() -> int:
    """``--ppo``: the on-policy family's phases alone (the kernels built
    first, as the full script builds them), for a short call while they
    change; the full script runs the trainers after the SAC trainers and
    the runs in the lanes."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sheeprl_tpu_torch.kernels import build

    clock = _PhaseClock()
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build.build_all()
    paths = {}
    for name in ONPOLICY_TRAINERS:
        paths[f"train_{name}"], _line = clock(f"train_{name}", phase_train_onpolicy, card, name)
    for name in ONPOLICY_RUN_SPECS:
        paths[name] = clock(name, phase_run_onpolicy, card, name)
    print("[timing] " + json.dumps(clock.line()), flush=True)
    print("[ppo_paths] " + json.dumps({k: v for k, v in paths.items()}), flush=True)
    return 0


def main_serve_ops() -> int:
    """``--serve-ops``: the serve command with every ops knob off and on in
    alternation (off, on, on, off) on a full-width DV3 checkpoint of a run
    that only collects (SERVE_OPS_CKPT_ARGS), with SERVE_CLIENTS ring
    clients and again with SERVE_OPS_FEW_CLIENTS (the host's cores not
    saturated), and the fault drill on a gateway of it: the ``[serve_ops]``
    line with the ops' cost, end to end and on the dispatcher thread. The
    whole script serves with the ops on only (its time has no room for a
    second serve command)."""
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sheeprl_tpu_torch.kernels import build
    from sheeprl_tpu_torch.serve import ServeGateway

    clock = _PhaseClock()
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build.build_all()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_ops_") as work:
        result, _wall = clock("checkpoint", _run_once, work, "serve_ops_ckpt", SERVE_OPS_CKPT_ARGS)
        ckpt, reg = result["checkpoint"], os.path.join(work, "registry")
        drill = clock("drill", _serve_fault_drill, ServeGateway.from_checkpoint(ckpt), os.path.join(work, "drill"))
        runs = {}
        for clients in (SERVE_CLIENTS, SERVE_OPS_FEW_CLIENTS):
            for i, ops in enumerate((False, True, True, False)):
                sub = os.path.join(work, f"serve{clients}_{i}")
                os.makedirs(sub)
                runs.setdefault((clients, ops), []).append(clock(
                    f"serve{clients}_{i}_{'on' if ops else 'off'}", _serve_command, ckpt, reg, ckpt, sub, ops=ops,
                    clients=clients))
    line = _serve_ops_line(runs[SERVE_CLIENTS, True][0], [r["row"] for r in runs[SERVE_CLIENTS, False]], drill, card)
    line["on_runs"] = [{k: r["row"][k] for k in SERVE_OPS_KEYS} for r in runs[SERVE_CLIENTS, True]]
    line["few_clients"] = {"clients": SERVE_OPS_FEW_CLIENTS, **{
        "on" if ops else "off": [{k: r["row"][k] for k in SERVE_OPS_KEYS} for r in runs[SERVE_OPS_FEW_CLIENTS, ops]]
        for ops in (False, True)}}
    print("[serve_ops] " + json.dumps(line), flush=True)
    print("[timing] " + json.dumps(clock.line()), flush=True)
    return 0


# The data-parallel phases (ROADMAP queue A item 7a; ``phase_ddp_nccl``, ``phase_ddp_gloo``). One card: NCCL refuses two ranks on one
# device, so the DDP path runs (1) as a world of one NCCL rank (spawned by ``parallel.spawn``) whose steps capture
# their all-reduces in the step's graph, held bitwise against the same steps outside a world; (2) as two gloo ranks
# sharing the card (gloo's host collectives keep the train step eager), held against the same two ranks on the CPU;
# and (3) ``fabric.devices=2`` through the CLI raises on the one card before anything is spawned.
DDP_NCCL_ALGOS = ("dreamer_v3", "dreamer_v2", "ppo")
# the two gloo ranks: DreamerV3 at the 100k MsPacman width, each rank's batch cut to 4 x 16, the world model at lr 0
# as the card-against-CPU steps run it (DV1_CPU_OVERRIDES), the actor and critic at the preset's rates
DDP_GLOO_OVERRIDES = {"per_rank_batch_size": 4, "per_rank_sequence_length": 16, "algo.world_model.optimizer.lr": 0.0}
DDP_GLOO_STEPS = 2
DDP_GLOO_HORIZON = 15
DV3_CELL_LAUNCHES_PER_STEP = 79  # the DV3 100k preset's trainer: 64 posterior steps + 15 imagination steps
DDP_PATHS = ("ddp_nccl_dreamer_v3", "ddp_nccl_dreamer_v2", "ddp_nccl_ppo", "ddp_gloo_dreamer_v3")


def _hashes(tensors: dict) -> dict:
    """A SHA-256 of each tensor's bytes (bitwise equality across processes)."""
    import hashlib

    return {k: hashlib.sha256(v.detach().cpu().contiguous().numpy().tobytes()).hexdigest() for k, v in tensors.items()}


def _ddp_update_steps() -> dict:
    """ONPOLICY_GRAPHED_UPDATES updates of PPO's preset (the Nature-CNN pixel
    update) from seed SEED, graphed, at the trainer's own permutations; the
    parameters' and the optimizer state's hashes and the metrics."""
    import torch

    cfg, agent, program, data, perms = onpolicy_trainer("ppo", "cuda")
    metrics = [program.update(data, _onpolicy_scalars(cfg), perms=perms).tolist()
               for _ in range(ONPOLICY_GRAPHED_UPDATES)]
    torch.cuda.synchronize()
    state = {f"opt.{i}.{k}": v for i, p in enumerate(agent.parameters())
             for k, v in program.optimizer.state[p].items() if isinstance(v, torch.Tensor)}
    out = {"metrics": metrics, "hashes": _hashes({**dict(agent.named_parameters()), **state}),
           "graph": {"eager_calls": program.step.eager_calls, "replays": program.step.replays,
                     "captured": program.step.graph is not None}}
    del agent, program, data
    torch.cuda.empty_cache()
    return out


def _ddp_steps(algo: str) -> dict:
    """``algo``'s graphed steps as the main phases run them (``_train_steps``,
    ``_ddp_update_steps``), with ``cudnn.deterministic``: inside a world, its
    collectives ride in the graph."""
    import torch

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        if algo == "ppo":
            return _ddp_update_steps()
        run = _train_steps(True, algo)
        return {"metrics": run["metrics"], "hashes": _hashes(run["params"]), "launches": run["launches"],
                "graph": run["graph"]}
    finally:
        torch.backends.cudnn.deterministic = prev


def _ddp_nccl_rank(fabric, algos) -> dict:
    """The one NCCL rank: each algorithm's graphed steps, then one more
    replay of DreamerV3's step under ``torch.profiler``, read by the port's
    trace parser (its NCCL kernels and ``comms_ms_total``)."""
    import torch

    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.obs.prof import trace
    from sheeprl_tpu_torch.tools import bench_dreamer
    from sheeprl_tpu_torch.train.burst import run_train_burst, tau_schedule

    out = {"world": (fabric.world_size, fabric.global_rank, fabric.backend), "runs": {}}
    for algo in algos:
        before = ops.hafner_cell_launches.count
        out["runs"][algo] = _ddp_steps(algo)
        out["runs"][algo]["launches"] = ops.hafner_cell_launches.count - before
    out["sequence_launches"] = ops.hafner_sequence_launches.count
    cfg, state, program, data = bench_dreamer.build_trainer("cuda", seed=0, algo="dreamer_v3")
    stack = {k: v[None] for k, v in data.items()}
    taus = tau_schedule(WARMUP_CALLS_DDP + 1, 0, 1, tau=0.02, first_hard=True)
    before = ops.hafner_cell_launches.count
    for i in range(WARMUP_CALLS_DDP):
        run_train_burst(program, state, stack, taus[i : i + 1], fetch_metrics=False)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run_train_burst(program, state, stack, taus[-1:], fetch_metrics=False)
        torch.cuda.synchronize()
    summary = trace.summarize_events(trace.events_from_profiler(prof))
    nccl = {}
    for _c, name, _ts, _dur, _tid, _corr in trace.events_from_profiler(prof):
        if trace.nccl_kind(name) is not None:
            nccl[name.split("(")[0]] = nccl.get(name.split("(")[0], 0) + 1
    out["profiled"] = {"replays": program.step.replays, "captured": program.step.graph is not None,
                       "comms_ms_total": summary["comms_ms_total"], "comms_ms_by_kind": summary["comms_ms_by_kind"],
                       "nccl_kernels": nccl, "launches": ops.hafner_cell_launches.count - before}
    return out


WARMUP_CALLS_DDP = 4  # three eager warm-up calls, the capture (a replay); the profiled call is the next replay


def _ddp_gloo_inputs(rank: int, step: int):
    """Rank ``rank``'s batch and noise for gloo step ``step``: drawn on the CPU from seeds."""
    import torch

    from sheeprl_tpu_torch import configs
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as train
    from sheeprl_tpu_torch.obs.prof.harness import synthetic_batch

    cfg = configs.dreamer_v2_config("dreamer_v3_100k_ms_pacman", **DDP_GLOO_OVERRIDES)
    T, B = int(cfg.per_rank_sequence_length), int(cfg.per_rank_batch_size)
    batch = synthetic_batch(T, B, N_ACTIONS, seed=1 + 10 * rank + step, continuous=False, obs=OBS)
    noise = train.draw_noise(cfg, (N_ACTIONS,), T, B, torch.Generator().manual_seed(SEED + 100 * rank + step), "cpu",
                             False)
    return {k: torch.from_numpy(v) for k, v in batch.items()}, noise


def _live_heads(state) -> None:
    """The reward and critic heads start at zero (Hafner): move them, and the
    target critic off the critic, from a seed, so that the returns, the
    advantage and the target term are not rounding noise (the JAX parity
    tests' set-up)."""
    import torch

    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for head in (state["world_model"].reward_model.head, state["critic"].head):
            head.weight.copy_(0.3 * torch.randn(tuple(head.weight.shape), generator=g))
        for t, c in zip(state["target_critic"].parameters(), state["critic"].parameters()):
            t.copy_(0.5 * c)


def _ddp_gloo_rank(fabric, choices=None) -> dict:
    """One of the two gloo ranks: DreamerV3 (the 100k width, DDP_GLOO_OVERRIDES)
    from seed 0's weights, broadcast from rank 0, DDP_GLOO_STEPS eager steps
    on this rank's batches and noise; each step's metrics, the state's
    hashes after each step, the step's graph counts and the cell's
    launches. Every straight-through sample is recorded (``choices`` None:
    returned) or replaced by the given run's choice (``_PinnedSamples``:
    a near-tie that rounding flipped is counted, not followed)."""
    import torch

    from sheeprl_tpu_torch.kernels import ops
    from sheeprl_tpu_torch.tools import bench_dreamer

    device = fabric.device
    pins = _PinnedSamples()
    if choices is not None:
        pins.replay = True
        pins.choices = [c.to(device) for c in choices[fabric.global_rank]]
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    cfg, state, program, _data = bench_dreamer.build_trainer(device, seed=0, algo="dreamer_v3", **DDP_GLOO_OVERRIDES)
    _live_heads(state)
    fabric.sync_modules(*(state[k] for k in ("world_model", "actor", "critic", "target_critic")))
    taus = [1.0] + [0.02] * (DDP_GLOO_STEPS - 1)
    from sheeprl_tpu_torch.train.burst import run_train_burst

    before = ops.hafner_cell_launches.count
    steps = []
    with pins:
        for i in range(DDP_GLOO_STEPS):
            batch, noise = _ddp_gloo_inputs(fabric.global_rank, i)
            moved = {k: [t.to(device) for t in v] if isinstance(v, list) else v.to(device) for k, v in noise.items()}
            stack = {k: v.to(device)[None] for k, v in batch.items()}
            metrics = run_train_burst(program, state, stack, taus[i : i + 1], noise=[moved])
            tensors = {f"{n}.{k}": v for n, m in _modules_of(state).items() for k, v in m.state_dict().items()}
            tensors.update({f"moments.{k}": v for k, v in state["moments"].items()})
            steps.append({"metrics": metrics, "hashes": _hashes(tensors)})
    if choices is not None and pins.index != len(pins.choices):
        raise AssertionError(f"the pinned run drew {pins.index} samples, the recorded one {len(pins.choices)}")
    step = program.step
    return {"steps": steps, "launches": ops.hafner_cell_launches.count - before,
            "choices": [c.cpu() for c in pins.choices] if choices is None else None,
            "flips": pins.flips, "samples": pins.samples,
            "sequence_launches": ops.hafner_sequence_launches.count,
            "graph": {"eager_calls": step.eager_calls, "replays": step.replays, "captured": step.graph is not None,
                      "eager_backend": step.eager_backend},
            "device": str(device), "world": (fabric.world_size, fabric.global_rank, fabric.backend)}


def phase_ddp_nccl(card: str) -> dict:
    """The data-parallel path in a world of one NCCL rank (ROADMAP queue A
    item 7a), and ``fabric.devices=2`` through the CLI on the one card;
    returns each path's launches (a rank is a process: its counts are its
    own, zero at its start)."""
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.parallel import spawn
    from sheeprl_tpu_torch.train.graphs import WARMUP_CALLS

    # the steps' collectives captured in their graphs, bitwise the same steps outside a world
    (nccl,) = spawn(_ddp_nccl_rank, 1, backend="nccl", device_of_rank="cuda:0", args=(DDP_NCCL_ALGOS,))
    alone = {algo: _ddp_steps(algo) for algo in DDP_NCCL_ALGOS}
    torch.cuda.empty_cache()
    bitwise, bad = {}, []
    for algo in DDP_NCCL_ALGOS:
        got, want = nccl["runs"][algo], alone[algo]
        bitwise[algo] = got["hashes"] == want["hashes"] and got["metrics"] == want["metrics"]
        if not bitwise[algo]:
            differ = sorted(k for k in want["hashes"] if got["hashes"].get(k) != want["hashes"][k])
            bad.append(f"{algo}: the one-rank NCCL steps differ from the steps outside a world ({differ[:5]})")
        if got["graph"] != want["graph"] or not got["graph"]["captured"]:
            bad.append(f"{algo}: graphs {got['graph']} against {want['graph']}")
    for algo, want in (("dreamer_v3", GRAPH_STEPS * DV3_CELL_LAUNCHES_PER_STEP),
                       ("dreamer_v2", GRAPH_STEPS * CELL_LAUNCHES_PER_STEP), ("ppo", 0)):
        if nccl["runs"][algo]["launches"] != want:
            bad.append(f"{algo}: {nccl['runs'][algo]['launches']} cell launches in the NCCL world, predicted {want}")
    prof = nccl["profiled"]
    if not prof["nccl_kernels"] or not prof["comms_ms_total"] or prof["comms_ms_total"] <= 0:
        bad.append(f"the profiled replay shows no NCCL kernel time: {prof}")
    if not prof["captured"] or prof["replays"] != WARMUP_CALLS_DDP + 1 - WARMUP_CALLS:
        bad.append(f"the profiled step ran as {prof}")
    if prof["launches"] != (WARMUP_CALLS_DDP + 1) * DV3_CELL_LAUNCHES_PER_STEP:
        bad.append(f"the profiled trainer launched the cell {prof['launches']} times")
    if nccl["sequence_launches"]:
        bad.append("the sequence kernel launched on a data-parallel path (no model path calls it)")

    # two devices through the CLI on one card raise before any rank is spawned
    try:
        cli.run(["exp=dreamer_v3", "env=dummy", "fabric.devices=2", "dry_run=True", "metric.log_level=0"])
        refusal = None
    except ValueError as err:
        refusal = str(err)
    if refusal is None or "only 1 are available" not in refusal:
        bad.append(f"fabric.devices=2 on one card: {refusal}")

    line = {"card": card, "backend": "nccl", "ranks": 1, "cards": 1, "graphs": "captured",
            "bitwise_vs_outside_a_world": bitwise,
            "graph_counts": {a: nccl["runs"][a]["graph"] for a in DDP_NCCL_ALGOS},
            "launches": {a: nccl["runs"][a]["launches"] for a in DDP_NCCL_ALGOS}, "profiled": prof,
            "refusal_devices_2": refusal}
    print("[ddp_nccl] " + json.dumps(line), flush=True)
    if bad:
        raise AssertionError(f"ddp_nccl: {bad}")
    zero = {"hafner_cell": 0, "hafner_sequence": 0}
    return {
        "ddp_nccl_dreamer_v3": {**zero, "hafner_cell": nccl["runs"]["dreamer_v3"]["launches"] + prof["launches"]},
        "ddp_nccl_dreamer_v2": {**zero, "hafner_cell": nccl["runs"]["dreamer_v2"]["launches"]},
        "ddp_nccl_ppo": {**zero, "hafner_cell": nccl["runs"]["ppo"]["launches"]},
    }


def phase_ddp_gloo(card: str) -> dict:
    """The data-parallel path on two gloo ranks sharing the card (ROADMAP
    queue A item 7a; gloo's host collectives keep the train step eager),
    held against the same two ranks on the CPU; returns the path's launches
    (the ranks' sum)."""
    from sheeprl_tpu_torch.parallel import spawn

    # the CPU's ranks first: the card's ranks take their straight-through samples' choices
    cpu_ranks = spawn(_ddp_gloo_rank, 2, backend="gloo", device_of_rank="cpu")
    card_ranks = spawn(_ddp_gloo_rank, 2, backend="gloo", device_of_rank="cuda:0",
                       args=([r["choices"] for r in cpu_ranks],))
    predicted = DDP_GLOO_STEPS * (DDP_GLOO_OVERRIDES["per_rank_sequence_length"] + DDP_GLOO_HORIZON)
    bad = []
    for ranks, where in ((card_ranks, "card"), (cpu_ranks, "cpu")):
        for i in range(DDP_GLOO_STEPS):
            if ranks[0]["steps"][i]["hashes"] != ranks[1]["steps"][i]["hashes"]:
                bad.append(f"gloo on the {where}: the ranks' states differ after step {i}")
            if ranks[0]["steps"][i]["metrics"] != ranks[1]["steps"][i]["metrics"]:
                bad.append(f"gloo on the {where}: the ranks' metrics differ at step {i}")
    for r, rank in enumerate(card_ranks):
        if rank["launches"] != predicted:
            bad.append(f"gloo rank {r} launched the cell {rank['launches']} times, predicted {predicted}")
        if rank["graph"] != {"eager_calls": DDP_GLOO_STEPS, "replays": 0, "captured": False, "eager_backend": "gloo"}:
            bad.append(f"gloo rank {r}'s step ran as {rank['graph']}")
        if rank["sequence_launches"]:
            bad.append("the sequence kernel launched on a data-parallel path (no model path calls it)")
    card_m, cpu_m = card_ranks[0]["steps"][0]["metrics"], cpu_ranks[0]["steps"][0]["metrics"]
    gaps = {k: abs(card_m[k] - cpu_m[k]) / max(abs(cpu_m[k]), 1e-6) for k in cpu_m}
    limits = {k: TOL_TRAIN_LOSS if k.startswith("Loss/") else TOL_TRAIN_GRAD for k in cpu_m}
    bad += [f"gloo card against CPU: {k} {gaps[k]:.3g} > {limits[k]}" for k in cpu_m if gaps[k] > limits[k]]
    last = card_ranks[0]["steps"][-1]["metrics"], cpu_ranks[0]["steps"][-1]["metrics"]
    line = {"card": card, "backend": "gloo", "ranks": 2, "cards": 1, "graphs": "eager (gloo)",
            "launches_per_rank": [r["launches"] for r in card_ranks], "predicted_per_rank": predicted,
            "graph_counts": card_ranks[0]["graph"], "bitwise_replicas_every_step": not any("differ" in b for b in bad),
            "card_vs_cpu_step0": {"rel_diff": gaps, "limits": limits},
            "card_vs_cpu_last_step_rel_diff": {k: abs(last[0][k] - last[1][k]) / max(abs(last[1][k]), 1e-6)
                                               for k in last[1]},
            "pinned_samples": {"flips": [r["flips"] for r in card_ranks], "samples": [r["samples"] for r in card_ranks]},
            "overrides": DDP_GLOO_OVERRIDES, "steps": DDP_GLOO_STEPS}
    print("[ddp_gloo] " + json.dumps(line), flush=True)
    if bad:
        raise AssertionError(f"ddp_gloo: {bad}")
    return {"ddp_gloo_dreamer_v3": {"hafner_cell": sum(r["launches"] for r in card_ranks), "hafner_sequence": 0}}


class _PhaseClock:
    """Each phase's wall seconds (printed as the ``[timing]`` line): the
    script must stay inside its 1,200 s limit on a slow host. ``lanes``
    holds each lane process's own line once it has ended (``_Lane``), with
    ``wall_s`` from its start to its collection: their phases ran beside
    the main process's, so the phases' seconds add up to more than
    ``total_s``."""

    def __init__(self, label: str = ""):
        self.seconds, self.start, self.label, self.lanes = {}, time.perf_counter(), label, {}

    def __call__(self, name: str, fn, *args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self.seconds[name] = round(self.seconds.get(name, 0.0) + time.perf_counter() - t, 1)
            print(f"[timing] {self.label}{name} {time.perf_counter() - t:.1f} s "
                  f"(total {time.perf_counter() - self.start:.1f} s)", flush=True)

    def line(self) -> dict:
        line = {"total_s": round(time.perf_counter() - self.start, 1), "phases_s": self.seconds}
        return {**line, "lanes": self.lanes} if self.lanes else line


# The phases that run in two more processes, the lanes (``chip_smoke.py --lane <name> <out>``), while the main
# process runs run, run_walker, eval_serve and the P2E runs: LANES["runs"], the DV1, L (with L Navigate and
# MineDojo) and XL runs and the SAC family's and two on-policy CLI runs; LANES["plane"], the decoupled runs and
# PPO-recurrent's run. Each path counts its launches in its own process with the counts zeroed just before it, as in
# the main process. What must have the card alone stays in the main process before them: the kernels' and the
# trainers' timings, and run_dv3 (its profiler window is held against CUDA events around the same replays). The
# decoupled runs' check of who holds the card reads each process of the plane (``_PlaneWatch``), so other processes
# on the card leave it as it is. The lanes' rates and idle shares are read beside the other processes' phases.
LANES = {
    "runs": ("run_dv1", "run_dv3_L", "run_dv3_XL", *SAC_RUN_SPECS, "run_sac_pendulum", "run_ppo_cartpole",
             "run_a2c_cartpole", "ddp_nccl"),
    "plane": ("run_sac_decoupled", "run_ppo_decoupled", "run_ppo_recurrent_cartpole", "ddp_gloo"),
}
LANE_TIMEOUT_S = 600


def _lane_phase(name: str, card: str, clock: "_PhaseClock") -> dict:
    """One of the lanes' phases, by name; returns its paths' launches."""
    if name in ("run_dv1", "run_dv3_XL"):
        return {name: clock(name, phase_run, card, name)[0]}
    if name == "run_dv3_L":
        return clock(name, phase_run_dv3_L, card)
    if name in SAC_RUN_SPECS:
        return {name: clock(name, phase_run_sac, card, name)}
    if name == "run_sac_pendulum":
        return {name: clock(name, phase_run_sac_pendulum, card)}
    if name in ONPOLICY_RUN_SPECS:
        return {name: clock(name, phase_run_onpolicy, card, name)}
    if name == "run_sac_decoupled":
        return clock(name, phase_run_sac_decoupled, card)
    if name == "run_ppo_decoupled":
        return clock(name, phase_run_ppo_decoupled, card)
    if name == "ddp_nccl":
        return clock(name, phase_ddp_nccl, card)
    if name == "ddp_gloo":
        return clock(name, phase_ddp_gloo, card)
    raise KeyError(name)


def main_lane(name: str, out: str) -> int:
    """``--lane <name> <out>``: LANES[name] in order, started by the full
    script once the kernels are built; writes their launches, their
    telemetry checks and their seconds to ``out`` as JSON."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    clock, card, paths = _PhaseClock(label=f"lane {name}: "), card_line(), {}
    for phase in LANES[name]:
        paths.update(_lane_phase(phase, card, clock))
    with open(out, "w") as f:
        json.dump({"paths": paths, "telemetry": TELEMETRY_CHECKS, **clock.line()}, f)
    return 0


class _Lane:
    """Lane ``name``'s process for the length of a ``with`` block: started in
    a session of its own, its output kept in files and echoed when it ends.
    Leaving the block waits for it (LANE_TIMEOUT_S from its start at most)
    and raises if it failed; ``paths`` are then its launches, and its
    telemetry checks join TELEMETRY_CHECKS. On an exception in the block, or
    on any way out, its whole process group is killed."""

    def __init__(self, clock: _PhaseClock, name: str):
        self.clock, self.name, self.paths = clock, name, None

    def __enter__(self):
        import tempfile

        here = os.path.dirname(os.path.abspath(__file__))
        self.dir = tempfile.mkdtemp(prefix=f"chip_smoke_lane_{self.name}_")
        self.out = os.path.join(self.dir, "lane.json")
        self.stdout = open(os.path.join(self.dir, "stdout"), "w+b")
        self.stderr = open(os.path.join(self.dir, "stderr"), "w+b")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"), "--lane", self.name, self.out], cwd=here,
            stdin=subprocess.DEVNULL, stdout=self.stdout, stderr=self.stderr, start_new_session=True)
        print(f"[lane] {self.name}, pid {self.proc.pid}: {', '.join(LANES[self.name])}", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        import shutil
        import signal

        rc = None
        try:
            if exc_type is None:
                t = time.perf_counter()
                try:
                    rc = self.proc.wait(timeout=max(LANE_TIMEOUT_S - (t - self.t0), 1.0))
                except subprocess.TimeoutExpired:
                    rc = "timeout"
                self.clock.seconds[f"lane_{self.name}_wait"] = round(time.perf_counter() - t, 1)
        finally:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)  # the lane and whatever of its group is left
            except ProcessLookupError:
                pass
            self.proc.wait()
            for src, dst in ((self.stdout, sys.stdout), (self.stderr, sys.stderr)):
                src.seek(0)
                dst.flush()
                dst.buffer.write(src.read())
                dst.flush()
                src.close()
            lane = None
            if rc == 0:
                with open(self.out) as f:
                    lane = json.load(f)
            shutil.rmtree(self.dir, ignore_errors=True)
        if exc_type is not None:
            return False
        if rc != 0:
            raise AssertionError(f"lane {self.name} ({', '.join(LANES[self.name])}) ended with {rc} "
                                 f"after {time.perf_counter() - self.t0:.1f} s")
        self.paths = lane.pop("paths")
        TELEMETRY_CHECKS.update(lane.pop("telemetry"))
        self.clock.lanes[self.name] = {"wall_s": round(time.perf_counter() - self.t0, 1), **lane}
        return False


def _descendants(root: int) -> list:
    """The live processes descended from ``root`` (read from ``/proc``)."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        children.setdefault(ppid, []).append(int(entry))
    stack, found = [root], []
    while stack:
        for pid in children.get(stack.pop(), ()):
            found.append(pid)
            stack.append(pid)
    return found


def _stop_descendants() -> None:
    """SIGKILL every live process descended from this one: what a failed
    phase left running (players, env workers, policy writers, the lanes)."""
    import signal

    for pid in _descendants(os.getpid()):
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


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
    # the SAC family's trainers (no kernel on their path), then the on-policy family's (PPO's pixel path, A2C and
    # PPO-recurrent): timed, so the card is theirs alone
    sac_train = {}
    for algo in SAC_TRAINERS:
        by_path[f"train_{algo}"], sac_train[algo] = clock(f"train_{algo}", phase_train_sac, card, algo)
    onpolicy_train = {}
    for name in ONPOLICY_TRAINERS:
        by_path[f"train_{name}"], onpolicy_train[name] = clock(f"train_{name}", phase_train_onpolicy, card, name)
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_serve_") as work:
        by_path["run_dv3"], dv3_ckpt = clock("run_dv3", phase_run, card, "run_dv3",
                                             keep_root=os.path.join(work, "run_dv3"))
        torch.cuda.empty_cache()  # the trainers' cached blocks, for the lanes' runs
        # the lanes beside these runs (LANES): the DV1, L and XL runs, the SAC family's runs and the device envs of
        # env.backend=jax, two of the JAX learning tests' runs on the CartPole stand-in; the actor-learner plane (no
        # kernel on its path: sac_decoupled's thread, 1-player and 2-player runs, ppo_decoupled's 2-player run),
        # then PPO-recurrent's run
        with _Lane(clock, "runs") as runs_lane, _Lane(clock, "plane") as plane_lane:
            by_path["run"], _ckpt = clock("run", phase_run, card, "run")
            by_path["run_walker"], walker_ckpt = clock("run_walker", phase_run, card, "run_walker",
                                                       keep_root=os.path.join(work, "run_walker"))
            by_path.update(clock("eval_serve", phase_eval_serve, card, work, dv3_ckpt, walker_ckpt))
            for family in RUN_P2E_SPECS:
                paths, _line = clock(f"run_{family}", phase_run_p2e, card, family, work)
                by_path.update(paths)
        by_path.update(runs_lane.paths)
        by_path.update(plane_lane.paths)
    print("[telemetry] " + json.dumps({"runs": telemetry_line(), "card": card}), flush=True)

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
            # the main paths' f32 runs: the DV2 MsPacman preset's, the DV3 100k, walker, L, L Navigate and XL
            # presets', the DV3 MineDojo run and its masked acting steps, the DV1 preset's (0) and the f32 P2E
            # presets' exploration and finetuning runs (P2E-DV1's 0; the bf16 presets' are hafner_cell_bf16's)
            "launches": sum(by_path[run]["hafner_cell"] for run in (*RUN_SPECS, *MINEDOJO_PATHS, *DDP_PATHS))
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
            # SAC, DroQ and SAC-AE: PyTorch operations only (no TPU kernel on their path), every path at 0 launches
            "sac_paths": {path: counts["hafner_cell"] for path, counts in by_path.items()
                          if path.startswith(("train_sac", "train_droq", "run_sac", "run_droq"))},
            "sac_train": sac_train,
            # PPO, A2C and PPO-recurrent: PyTorch operations only (no TPU kernel on their path), every path at 0
            # launches of the cell and of the sequence
            "ppo_paths": {path: counts for path, counts in by_path.items()
                          if path in {f"train_{n}" for n in ONPOLICY_TRAINERS} | set(ONPOLICY_RUN_SPECS)},
            "ppo_train": onpolicy_train,
            # sac_decoupled and ppo_decoupled: PyTorch operations only, every run at 0 launches of both kernels
            "decoupled_paths": {path: counts for path, counts in by_path.items() if "decoupled" in path},
            # the data-parallel paths (ROADMAP 7a): DV3, DV2 and PPO in a world of one NCCL rank, DV3 on two gloo
            # ranks sharing the card (the ranks' sum)
            "ddp_paths": {path: by_path[path] for path in DDP_PATHS},
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


# the trainers whose timed steps the script reads (phase_train, phase_train_dv3, phase_train_p2e, phase_train_dv1)
TIMED_TRAINERS = ("dreamer_v2", "dreamer_v3", "dreamer_v3_walker", "p2e_dv3", "p2e_dv3_continuous", "p2e_dv2",
                  "p2e_dv3_L_bf16", "dreamer_v3_L", "dreamer_v3_XL", "dreamer_v1", "p2e_dv1")


def main_train_steps() -> int:
    """``--train-steps``: each timed trainer's readings (``bench_dreamer.compare``,
    eager and graphed, as many steps profiled as timed) at PROFILED_STEPS and
    at TRAIN_STEPS steps, in the order 2, 4, 4, 2, one JSON line a trainer:
    the steps/s, the device's busy ms a step and its idle share of the timed
    steps at each count, and for each reading the difference of the two
    counts' means against the spread between repeats at one count."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sheeprl_tpu_torch.kernels import build
    from sheeprl_tpu_torch.tools import bench_dreamer

    card = card_line()
    print(f"[card] {card}", flush=True)
    build.build_all()
    keys = ("value", "device_busy_ms_per_step", "device_idle_share_of_timed_steps")
    for algo in TIMED_TRAINERS:
        reads = {}
        for steps in (PROFILED_STEPS, TRAIN_STEPS, TRAIN_STEPS, PROFILED_STEPS):
            result = bench_dreamer.compare(steps=steps, device="cuda", profile=True, algo=algo)
            for mode in ("eager", "graphed"):
                for key in keys:
                    reads.setdefault(mode, {}).setdefault(key, {}).setdefault(steps, []).append(result[mode][key])
        line = {"algo": algo, "card": card, "readings": reads, "against_spread": {}}
        for mode, by_key in reads.items():
            for key, by_steps in by_key.items():
                mean = {n: statistics.mean(v) for n, v in by_steps.items()}
                spread = max(max(v) - min(v) for v in by_steps.values())
                line["against_spread"][f"{mode}.{key}"] = {"mean_diff": mean[PROFILED_STEPS] - mean[TRAIN_STEPS],
                                                           "spread": spread}
        print("[train_steps] " + json.dumps(line), flush=True)
    return 0


def main_sac() -> int:
    """``--sac``: the SAC family's phases alone (the kernels built first, as
    the full script builds them), for a short call while they change; the
    full script runs the trainers after the DreamerV1 trainers and the runs
    in the ``runs`` lane."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sheeprl_tpu_torch.kernels import build

    clock = _PhaseClock()
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build.build_all()
    paths = {}
    for algo in SAC_TRAINERS:
        paths[f"train_{algo}"], _line = clock(f"train_{algo}", phase_train_sac, card, algo)
    for name in SAC_RUN_SPECS:
        paths[name] = clock(name, phase_run_sac, card, name)
    paths["run_sac_pendulum"] = clock("run_sac_pendulum", phase_run_sac_pendulum, card)
    print("[timing] " + json.dumps(clock.line()), flush=True)
    print("[sac_paths] " + json.dumps({k: v["hafner_cell"] for k, v in paths.items()}), flush=True)
    return 0


def _dispatch() -> int:
    modes = {"--train-gaps": main_train_gaps, "--sac": main_sac, "--ppo": main_ppo, "--decoupled": main_decoupled,
             "--serve-ops": main_serve_ops, "--train-steps": main_train_steps}
    if sys.argv[1:2] == ["--seeds"] and len(sys.argv) > 3:
        return main_seeds(sys.argv[2:])
    if sys.argv[1:2] == ["--lane"] and len(sys.argv) == 4:
        return main_lane(sys.argv[2], sys.argv[3])
    return modes[sys.argv[1]]() if sys.argv[1:2] and sys.argv[1] in modes and len(sys.argv) == 2 else main()


if __name__ == "__main__":
    # a failed phase can leave processes behind (a writer that ignores SIGTERM is joined at exit): the script
    # stops every process it started and leaves without waiting on any
    try:
        code = _dispatch()
    except SystemExit as stop:
        code = stop.code if isinstance(stop.code, int) else int(stop.code is not None)
    except BaseException:
        import traceback

        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    _stop_descendants()
    os._exit(code)
