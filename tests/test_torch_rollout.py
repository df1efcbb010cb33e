"""The port's device envs, rollout engine and device ring on the CPU.

- ``CartPole`` and ``Pendulum`` against gymnasium itself (not against the
  JAX package's float32 ports): each device env starts from the state
  gymnasium reset to and takes the same actions for a whole episode. The
  port keeps the state in float64, as gymnasium does, so the observations
  (float32 casts of float64 states) agree within 1e-6 and the rewards
  within 1e-9 (measured: 0 and 2e-15).
- The engine's rows against a host loop over gymnasium envs given the same
  actions and the same reset states, every env ending inside the burst
  (the semantics of the JAX package's
  ``test_jitted_scan_collection_semantics_vs_host_reference``: actions,
  dones and rewards bitwise, observations within 1e-6); and one burst of 50
  against five of 10 on the same noise, bitwise.
- The ring: ``scatter_append``'s wraparound (``test_scatter_append_wraparound``),
  the engine's appends adopted and synced to the host for a checkpoint,
  and the sampled window (the newest row excluded under
  ``sample_next_obs``).
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.data.device_ring import DeviceRingTransitions, scatter_append
from sheeprl_tpu_torch.envs.rollout import CartPole, Pendulum, RolloutEngine, device_env_ids, make_device_env
from sheeprl_tpu_torch.envs.rollout.engine import host_rows


def _gym_state(env, port_state, i):
    """Set gymnasium env ``env``'s state to row ``i`` of the port's state."""
    inner = env.unwrapped
    if "phys" in port_state:
        inner.state = port_state["phys"][i].numpy().astype(np.float64)
        inner.steps_beyond_terminated = None
    else:
        inner.state = np.array([float(port_state["th"][i]), float(port_state["thdot"][i])])


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1"])
def test_device_envs_match_gymnasium(env_id):
    n = 6
    rng = np.random.default_rng(0)
    envs = [gym.make(env_id) for _ in range(n)]
    device_env = make_device_env(env_id, n, "cpu")
    assert device_env.max_episode_steps == envs[0].spec.max_episode_steps
    gym_obs = np.stack([e.reset(seed=i)[0] for i, e in enumerate(envs)])
    phys = [e.unwrapped.state for e in envs]
    if env_id == "CartPole-v1":
        state = {"phys": torch.tensor(np.stack(phys), dtype=torch.float64)}
    else:
        state = {"th": torch.tensor([p[0] for p in phys], dtype=torch.float64),
                 "thdot": torch.tensor([p[1] for p in phys], dtype=torch.float64)}
    state["elapsed"] = torch.zeros(n, dtype=torch.int64)
    alive = np.ones(n, bool)
    for _ in range(device_env.max_episode_steps):
        if env_id == "CartPole-v1":
            actions = rng.integers(0, 2, (n, 1)).astype(np.float32)
        else:
            actions = rng.uniform(-2.5, 2.5, (n, 1)).astype(np.float32)  # clipped to ±2 by both
        state, obs, reward, terminated, truncated = device_env.step(state, torch.from_numpy(actions))
        for i, env in enumerate(envs):
            if not alive[i]:
                continue
            o, r, te, tr, _ = env.step(int(actions[i, 0]) if env_id == "CartPole-v1" else actions[i])
            np.testing.assert_allclose(obs[i].numpy(), o, rtol=0, atol=1e-6)
            assert abs(float(reward[i]) - r) <= 1e-9
            assert (bool(terminated[i]), bool(truncated[i])) == (te, tr)
            alive[i] = not (te or tr)
        if not alive.any():
            break
    assert not alive.any() and gym_obs.dtype == np.float32


def test_device_env_resets_and_ids():
    generator = torch.Generator().manual_seed(0)
    for env in (CartPole(512, "cpu"), Pendulum(512, "cpu")):
        state, obs = env.reset(env.reset_noise(generator))
        assert obs.shape == (512, env.obs_dim) and obs.dtype == torch.float32
        assert all(v.dtype in (torch.float64, torch.int64) for v in state.values())
        actions = env.sample_action(env.action_noise(generator))
        low, high = (-2.0, 2.0) if isinstance(env, Pendulum) else (0.0, 1.0)
        assert float(actions.min()) >= low and float(actions.max()) <= high
    cart, _ = CartPole(512, "cpu").reset(CartPole(512, "cpu").reset_noise(generator))
    assert float(cart["phys"].abs().max()) <= 0.05
    pend, _ = Pendulum(512, "cpu").reset(Pendulum(512, "cpu").reset_noise(generator))
    assert float(pend["th"].abs().max()) <= np.pi and float(pend["thdot"].abs().max()) <= 1.0
    assert device_env_ids() == ("CartPole-v1", "Pendulum-v1")
    assert make_device_env("Pendulum-v1", 1, "cpu", 17).max_episode_steps == 17
    with pytest.raises(NotImplementedError, match="brax"):
        make_device_env("brax/ant", 1, "cpu")
    with pytest.raises(ValueError, match="Python vector-env plane"):
        make_device_env("MountainCar-v0", 1, "cpu")


def test_engine_rows_match_a_gymnasium_host_loop():
    n, burst = 4, 50
    generator = torch.Generator().manual_seed(123)
    engine = RolloutEngine(CartPole(n, "cpu"), generator)
    start = engine.env.reset_noise(generator)
    engine.reset(start)
    noise = engine.draw_noise(burst, random_actions=True)
    rows, stats = engine.collect(burst, random_actions=True, noise=noise)
    got = host_rows(rows)

    envs = [gym.make("CartPole-v1") for _ in range(n)]
    reset_state, _ = engine.env.reset(start)
    obs = np.zeros((n, 4), np.float32)
    for i, env in enumerate(envs):
        env.reset(seed=i)
        _gym_state(env, reset_state, i)
        obs[i] = env.unwrapped.state.astype(np.float32)
    ended = 0
    for t in range(burst):
        actions = np.floor(noise["actions"][t].numpy() * 2.0).clip(max=1.0)
        next_obs, rewards, dones = np.zeros_like(obs), np.zeros(n, np.float32), np.zeros(n, np.float32)
        carried = obs.copy()
        resets, _ = engine.env.reset(noise["reset"][t])
        for i, env in enumerate(envs):
            o, r, te, tr, _ = env.step(int(actions[i, 0]))
            next_obs[i], rewards[i], dones[i] = o, r, float(te or tr)
            carried[i] = o
            if te or tr:
                ended += 1
                env.reset()
                _gym_state(env, resets, i)
                carried[i] = env.unwrapped.state.astype(np.float32)
        np.testing.assert_array_equal(got["actions"][t], actions, err_msg=f"step {t}")
        np.testing.assert_array_equal(got["dones"][t][:, 0], dones, err_msg=f"step {t}")
        np.testing.assert_array_equal(got["rewards"][t][:, 0], rewards, err_msg=f"step {t}")
        np.testing.assert_allclose(got["observations"][t], obs, rtol=0, atol=1e-6, err_msg=f"step {t}")
        np.testing.assert_allclose(got["next_observations"][t], next_obs, rtol=0, atol=1e-6, err_msg=f"step {t}")
        obs = carried
    assert ended >= n, "every env must end inside the burst"
    ep_len = stats[3].numpy()
    assert (ep_len[stats[1].numpy()] >= 1).all()


def test_one_burst_is_five_shorter_ones():
    n = 3
    runs = []
    for split in (50, 10):
        generator = torch.Generator().manual_seed(7)
        engine = RolloutEngine(Pendulum(n, "cpu"), generator,
                               policy=lambda obs, eps: torch.tanh(obs[:, :1] + eps) * 2.0)
        engine.reset(engine.env.reset_noise(torch.Generator().manual_seed(1)))
        noise = engine.draw_noise(50, random_actions=False)
        parts = [host_rows(engine.collect(split, noise={k: v[s:s + split] for k, v in noise.items()})[0])
                 for s in range(0, 50, split)]
        runs.append({k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
        assert engine.bursts == 50 // split and engine.env_steps == 50 * n
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k], runs[1][k], err_msg=k)


def test_scatter_append_wraparound():
    cap, n_envs, t = 8, 3, 6
    bufs = {"x": torch.zeros((cap, n_envs, 2))}
    rows = {"x": torch.arange(t * n_envs * 2, dtype=torch.float32).reshape(t, n_envs, 2)}
    pos = 5  # 5, 6, 7, 0, 1, 2: wraps
    scatter_append(bufs, torch.tensor(pos), rows, cap)
    expect = np.zeros((cap, n_envs, 2), np.float32)
    for i in range(t):
        expect[(pos + i) % cap] = rows["x"][i].numpy()
    np.testing.assert_array_equal(bufs["x"].numpy(), expect)
    with pytest.raises(ValueError, match="exceeds the ring capacity"):
        scatter_append({"x": torch.zeros((4, 1))}, torch.tensor(0), {"x": torch.zeros((5, 1))}, 4)


def test_ring_adopt_and_sync_host_roundtrip():
    cap, n_envs = 10, 2
    rb = ReplayBuffer(cap, n_envs, obs_keys=("observations",))
    ring = DeviceRingTransitions(rb, "cpu", torch.Generator().manual_seed(0))
    engine = RolloutEngine(CartPole(n_envs, "cpu"), torch.Generator().manual_seed(0), ring=ring)
    engine.collect(7, random_actions=True)
    assert rb._pos == 7 and not rb.full and int(ring.pos) == 7
    engine.collect(7, random_actions=True)  # wraps: 14 rows into 10
    assert rb._pos == 4 and rb.full and int(ring.pos) == 4
    batch = ring.sample_device(4, n_samples=3)  # before any host copy exists
    assert batch["observations"].shape == (3, 4, 4) and batch["actions"].shape == (3, 4, 1)
    state = ring.state_dict()
    assert state["pos"] == 4 and state["full"]
    np.testing.assert_array_equal(rb.buffer["observations"], ring.buffers["observations"].numpy())
    assert np.abs(rb.buffer["observations"]).sum() > 0
    restored = DeviceRingTransitions(ReplayBuffer(cap, n_envs, obs_keys=("observations",)), "cpu",
                                     torch.Generator().manual_seed(0))
    restored.load_state_dict(state)
    assert int(restored.pos) == 4
    for k, v in ring.buffers.items():
        assert torch.equal(restored.buffers[k], v)


def test_ring_samples_the_valid_window():
    cap, n_envs = 6, 2
    ring = DeviceRingTransitions(ReplayBuffer(cap, n_envs, obs_keys=("observations",)), "cpu",
                                 torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="No sample"):
        ring.sample_device(2)

    def add(t0, steps):
        t = np.arange(t0, t0 + steps, dtype=np.float32)
        ring.add({"observations": np.repeat(t[:, None, None], n_envs, 1), "actions": np.zeros((steps, n_envs, 1),
                                                                                                np.float32)})

    add(0, 1)
    with pytest.raises(RuntimeError, match="only one sample"):
        ring.sample_device(2, sample_next_obs=True)
    add(1, 3)  # rows 0..3 written
    drawn = ring.sample_device(64, sample_next_obs=True, n_samples=8)
    assert set(np.unique(drawn["observations"].numpy())) == {0.0, 1.0, 2.0}
    np.testing.assert_array_equal(drawn["next_observations"].numpy(), drawn["observations"].numpy() + 1)
    add(4, 5)  # rows 4..8: the ring holds 3..8, the newest (8) at slot 2
    assert ring.full and ring.host._pos == 3
    drawn = ring.sample_device(64, sample_next_obs=True, n_samples=8)
    assert set(np.unique(drawn["observations"].numpy())) == {3.0, 4.0, 5.0, 6.0, 7.0}
    np.testing.assert_array_equal(drawn["next_observations"].numpy(), drawn["observations"].numpy() + 1)
    drawn = ring.sample_device(64, n_samples=8)
    assert set(np.unique(drawn["observations"].numpy())) == {3.0, 4.0, 5.0, 6.0, 7.0, 8.0}


def test_the_device_backend_and_sac_ae_runs_load_none_of_the_card_path_exclusions(tmp_path):
    """The card's SAC-family paths in a fresh interpreter: SAC on the device
    Pendulum (``env.backend=jax``: the engine, the ring, the test episode on
    the device env), SAC-AE on the dummy env's stacked pixels and the
    serving of its checkpoint. PyYAML, gymnasium, OpenCV, tensorboardX, JAX
    and the JAX package are never imported."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    forbidden = ("yaml", "gymnasium", "cv2", "tensorboardX", "jax", "sheeprl_tpu")
    code = (
        "import sys, warnings\n"
        "warnings.simplefilter('ignore')\n"
        "from sheeprl_tpu_torch import cli\n"
        "from sheeprl_tpu_torch.serve.model import load_gateway_model\n"
        f"base = ['fabric.accelerator=cpu', 'root_dir={tmp_path}', 'metric.log_level=1', 'buffer.memmap=False',\n"
        "        'env.num_envs=2', 'algo.hidden_size=8', 'per_rank_batch_size=2']\n"
        "sac = cli.run(base + ['exp=sac', 'env.backend=jax', 'env.id=Pendulum-v1', 'total_steps=16',\n"
        "                      'algo.learning_starts=4', 'buffer.size=32', 'env.act_burst=2', 'run_name=jaxb'])\n"
        "assert sac['engine']['bursts'] == 4 and sac['test_steps'] == 200, sac\n"
        "ae = cli.run(base + ['exp=sac_ae', 'env=dummy', 'env.id=continuous_dummy', 'env.sync_env=True',\n"
        "                     'env.frame_stack=3', 'dry_run=True', 'algo.dense_units=8', 'algo.encoder.features_dim=8',\n"
        "                     'algo.cnn_channels_multiplier=1', 'buffer.size=8', 'run_name=ae'])\n"
        "assert load_gateway_model(ae['checkpoint'], device='cpu')[0].algo == 'sac_ae'\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {forbidden!r}))\n"
        "print('loaded:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(repo))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "loaded: []" in proc.stdout
