"""Recurrent PPO training (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/ppo_recurrent.py``): PPO's loop
(:func:`~sheeprl_tpu_torch.algos.ppo.ppo.train_loop`) with the LSTM state
carried through the rollout and sequence minibatches.

Acting, as the JAX loop's host bookkeeping: each step feeds the carried
``(c, h)``, the previous actions and ``is_first`` (ones at the start) to the
agent for one step (one CUDA graph replay on the card) and records the
``(c, h)`` it started from; after the env step the next previous actions
are this step's, and with ``reset_recurrent_state_on_done`` an ended env's
previous actions and state are zeroed and its ``is_first`` set. A
truncated env's bootstrap ``V(s′)`` runs from this step's actions and the
unmasked state.

The update: the rollout (``rollout_steps``, a multiple of
``per_rank_sequence_length`` L) is cut into ``[L, n_seq, ...]`` chunks,
env-major (:func:`to_seq`), each with the ``(c, h)`` its first step
started from (:func:`to_hc`); ``update_epochs`` passes over a permutation of
the sequences, ``per_rank_num_batches`` minibatches each, the loss over
every step of every sequence, the carry zeroed inside the sequence at the
stored ``is_first``. The checkpoint holds the JAX tree's entries
(``params``, ``opt_state``, ``update``, ``num_batches``, ``last_log``,
``last_checkpoint``)."""

from __future__ import annotations

import warnings
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.ppo import PPO, UpdateProgram, open_run, optimizer_entry, ppo_loss, train_loop
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent, sample_actions
from sheeprl_tpu_torch.algos.ppo_recurrent.utils import normalize_obs, recurrent_greedy
from sheeprl_tpu_torch.utils.registry import register_algorithm

__all__ = ["RecurrentPPO", "main", "recurrent_forward", "select_sequences", "to_hc", "to_seq"]

#: the update's data keys that hold one row a sequence (the chunk's initial state)
_PER_SEQUENCE = ("hc_c", "hc_h")


def to_seq(x, seq_len: int):
    """``[T, E, ...]`` → ``[L, E·(T/L), ...]``: the rollout's ``T/L`` chunks of
    each env, env-major (the JAX ``to_seq``); numpy or torch."""
    if isinstance(x, torch.Tensor):
        n_chunks = x.shape[0] // seq_len
        x = x[: n_chunks * seq_len].reshape((n_chunks, seq_len) + tuple(x.shape[1:])).movedim(0, 2)
        return x.reshape((seq_len, -1) + tuple(x.shape[3:]))
    x = np.asarray(x)
    n_chunks = x.shape[0] // seq_len
    x = np.moveaxis(x[: n_chunks * seq_len].reshape((n_chunks, seq_len) + x.shape[1:]), 0, 2)
    return x.reshape((seq_len, -1) + x.shape[3:])


def to_hc(x: np.ndarray, seq_len: int) -> np.ndarray:
    """``[T, E, H]`` per-step states → ``[E·(T/L), H]``: the state each chunk
    starts from, in :func:`to_seq`'s order (the JAX ``to_hc``)."""
    x = np.asarray(x)[::seq_len]
    return np.moveaxis(x, 0, 1).reshape(-1, x.shape[-1])


def select_sequences(data: Mapping[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: v.index_select(0 if k in _PER_SEQUENCE else 1, idx) for k, v in data.items()}


def recurrent_forward(agent, obs, batch):
    pre_dist, values, _ = agent(obs, batch["prev_actions"], batch["is_first"], (batch["hc_c"], batch["hc_h"]))
    return pre_dist, values


class RecurrentPPO(PPO):
    """The ``ppo_recurrent`` family's hooks (see the module docstring)."""

    batch_entry = "num_batches"
    stored = ("logprobs", "prev_actions", "is_first")

    def __init__(self, fabric, cfg, run):
        self.seq_len = int(cfg.get("per_rank_sequence_length") or cfg.algo.rollout_steps)
        if int(cfg.algo.rollout_steps) % self.seq_len != 0:
            raise ValueError(
                f"The rollout steps ({cfg.algo.rollout_steps}) must be a multiple of the sequence length "
                f"({self.seq_len})"
            )
        self.reset_on_done = bool(cfg.algo.get("reset_recurrent_state_on_done", True))
        self.carry: Optional[Dict[str, np.ndarray]] = None
        super().__init__(fabric, cfg, run)
        self.carry = self.initial_carry()
        self.t, self.cx, self.hx = 0, None, None

    def build_agent(self, generator: torch.Generator) -> torch.nn.Module:
        r = self.run
        return build_agent(self.cfg, r.actions_dim, r.is_continuous, r.cnn_keys, r.mlp_keys, r.observation_space,
                           generator, device=self.device)

    @staticmethod
    def samples(cfg) -> int:
        """The sequences an update takes: ``rollout_steps / L`` chunks of every env."""
        seq_len = int(cfg.get("per_rank_sequence_length") or cfg.algo.rollout_steps)
        return (int(cfg.algo.rollout_steps) // seq_len) * int(cfg.env.num_envs)

    @classmethod
    def make_program(cls, cfg, agent, optimizer, run, n_samples: int, device) -> UpdateProgram:
        num_batches = int(cfg.get("per_rank_num_batches", 1) or 1)
        bs = max(n_samples // num_batches, 1)
        if n_samples % bs != 0:
            warnings.warn(
                f"per_rank_num_batches ({num_batches}) does not evenly divide the per-device sequence count "
                f"({n_samples}); each epoch drops the tail of its shuffle"
            )
        loss = ppo_loss(cfg, run.cnn_keys, run.obs_keys, run.actions_dim, run.is_continuous, forward=recurrent_forward)
        return UpdateProgram(loss, select_sequences, agent, optimizer,
                             max_grad_norm=float(cfg.algo.max_grad_norm or 0.0), epochs=int(cfg.algo.update_epochs),
                             n_samples=n_samples, batch_size=bs, n_metrics=len(cls.loss_names), n_scalars=2,
                             generator=run.generator, device=device)

    def initial_carry(self) -> Dict[str, np.ndarray]:
        n, hidden = self.run.n_envs, self.agent.rnn_hidden_size
        return {"prev_actions": np.zeros((n, int(sum(self.run.actions_dim))), np.float32),
                "is_first": np.ones((n, 1), np.float32), "hc_c": np.zeros((n, hidden), np.float32),
                "hc_h": np.zeros((n, hidden), np.float32)}

    # -- acting ---------------------------------------------------------------

    def acting_inputs(self, obs: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        carry = self.carry if self.carry is not None else self.initial_carry()
        return {**{k: obs[k] for k in self.run.obs_keys}, **carry}

    def acting_policy(self, inputs, noise):
        r = self.run
        seq_obs = {k: v[None] for k, v in normalize_obs(inputs, r.cnn_keys, r.obs_keys).items()}
        pre_dist, values, (c, h) = self.agent(seq_obs, inputs["prev_actions"][None], inputs["is_first"][None],
                                              (inputs["hc_c"], inputs["hc_h"]))
        actions, real, logprob = sample_actions([p[0] for p in pre_dist], r.is_continuous, noise)
        return actions, real, logprob, values[0], c, h

    def rollout_start(self) -> None:
        shape = (self.n_steps, self.run.n_envs, self.agent.rnn_hidden_size)
        self.t, self.cx, self.hx = 0, np.empty(shape, np.float32), np.empty(shape, np.float32)

    def act(self, obs: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        self.cx[self.t], self.hx[self.t] = self.carry["hc_c"], self.carry["hc_h"]
        self.t += 1
        actions, real, logprob, values, c, h = self.acting(self.acting_inputs(obs))
        return {"actions": actions, "real": real, "logprobs": logprob, "values": values, "c": c, "h": h}

    def rows(self, out: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {"logprobs": out["logprobs"], "prev_actions": self.carry["prev_actions"].copy(),
                "is_first": self.carry["is_first"].copy()}

    def after_step(self, out: Mapping[str, np.ndarray], dones: np.ndarray) -> None:
        n = self.run.n_envs
        prev = np.array(out["actions"], np.float32).reshape(n, -1)
        c, h = out["c"], out["h"]
        if self.reset_on_done:
            is_first = dones.reshape(n, 1).astype(np.float32)
            prev[dones.reshape(-1) > 0] = 0.0
            if np.any(dones):
                keep = 1.0 - is_first
                c, h = c * keep, h * keep
        else:
            is_first = np.zeros((n, 1), np.float32)
        self.carry = {"prev_actions": prev, "is_first": is_first, "hc_c": np.asarray(c, np.float32),
                      "hc_h": np.asarray(h, np.float32)}

    @torch.no_grad()
    def _value(self, obs, prev_actions, is_first, c, h) -> np.ndarray:
        r = self.run
        to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(self.device)  # noqa: E731
        seq_obs = {k: v[None] for k, v in normalize_obs({k: to(obs[k]) for k in r.obs_keys}, r.cnn_keys,
                                                        r.obs_keys).items()}
        _, values, _ = self.agent(seq_obs, to(prev_actions)[None], to(is_first)[None], (to(c), to(h)))
        return values[0].cpu().numpy()

    def value(self, obs, out=None, env_ids=None) -> np.ndarray:
        """``V(s′)`` of truncated envs: this step's actions, ``is_first`` 0, the unmasked state."""
        ids = np.asarray(env_ids)
        m = len(ids)
        return self._value(obs, np.asarray(out["actions"], np.float32).reshape(len(out["actions"]), -1)[ids],
                           np.zeros((m, 1), np.float32), out["c"][ids], out["h"][ids])

    def next_value(self, obs) -> torch.Tensor:
        carry = self.carry
        return torch.from_numpy(self._value(obs, carry["prev_actions"], carry["is_first"], carry["hc_c"],
                                            carry["hc_h"]))

    # -- the update -----------------------------------------------------------

    def update_data(self, rb, returns: torch.Tensor, advantages: torch.Tensor) -> Dict[str, Any]:
        L = self.seq_len
        keys = (*self.run.obs_keys, "actions", "prev_actions", "is_first", "logprobs", "values")
        data = {k: to_seq(np.asarray(rb[k])[: self.n_steps], L) for k in keys}
        data["returns"] = to_seq(returns[: self.n_steps], L)
        data["advantages"] = to_seq(advantages[: self.n_steps], L)
        data["hc_c"], data["hc_h"] = to_hc(self.cx, L), to_hc(self.hx, L)
        return data

    def checkpoint_entries(self) -> Dict[str, Any]:
        return {
            "params": {k: v.detach() for k, v in self.agent.state_dict().items()},
            "opt_state": optimizer_entry(self.optimizer),
            "num_batches": int(self.cfg.get("per_rank_num_batches", 1) or 1),
        }

    def greedy(self):
        act = recurrent_greedy(self.agent, self.run.cnn_keys, self.run.mlp_keys, 1, self.device)
        box = {"state": None}

        def step(obs):
            real, box["state"] = act(obs, box["state"])
            return real

        return step


@register_algorithm()
def main(fabric, cfg) -> Dict[str, Any]:
    """The recurrent PPO training run (see :func:`~sheeprl_tpu_torch.algos.ppo.ppo.train_loop`)."""
    if "minedojo" in str(cfg.env.wrapper.get("_target_", "") or "").lower():
        raise ValueError(
            "MineDojo is not currently supported by PPO Recurrent agent, since it does not take into consideration "
            "the action masks provided by the environment."
        )
    run = open_run(fabric, cfg, "PPO recurrent")
    return train_loop(fabric, cfg, run, RecurrentPPO(fabric, cfg, run))
