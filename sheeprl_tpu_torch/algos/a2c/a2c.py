"""A2C training (counterpart of ``sheeprl_tpu/algos/a2c/a2c.py``): PPO's
agent, rollout, GAE and loop (:func:`~sheeprl_tpu_torch.algos.ppo.ppo.train_loop`)
with A2C's update: one pass over a permutation of the rollout's samples in
minibatches, each gradient step on the unclipped ``−(A·log π)``, the value
loss with clipping off and ``− ent_coef · mean(entropy)``; no annealing
and no stored log-probs. The preset's 5-step rollout of 4 envs with a batch
of 64 makes one minibatch step an update. The checkpoint holds the JAX
tree's entries (``params``, ``opt_state``, ``update``, ``batch_size``,
``last_log``, ``last_checkpoint``)."""

from __future__ import annotations

import warnings
from typing import Any, Dict, Sequence

import torch

from sheeprl_tpu_torch.algos.a2c.loss import policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.agent import evaluate_actions
from sheeprl_tpu_torch.algos.ppo.ppo import PPO, UpdateProgram, open_run, select_rows, train_loop
from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import normalize_tensor

__all__ = ["A2C", "LOSS_NAMES", "a2c_loss", "main"]

#: the update's metrics, in the order of its stacked output
LOSS_NAMES = ("Loss/policy_loss", "Loss/value_loss")


def a2c_loss(cfg, cnn_keys: Sequence[str], obs_keys: Sequence[str], actions_dim: Sequence[int],
             is_continuous: bool):
    """A2C's minibatch loss at ``cfg``: ``(loss, [policy, value])``; the
    update's scalars are unused (A2C anneals nothing)."""
    reduction, vf_coef, ent_coef = cfg.algo.loss_reduction, float(cfg.algo.vf_coef), float(cfg.algo.ent_coef)
    norm_adv = bool(cfg.algo.normalize_advantages)

    def loss_fn(agent, batch, scalars):
        pre_dist, new_values = agent(normalize_obs(batch, cnn_keys, obs_keys))
        adv = normalize_tensor(batch["advantages"]) if norm_adv else batch["advantages"]
        new_logprobs, entropy = evaluate_actions(pre_dist, batch["actions"], actions_dim, is_continuous)
        pg = policy_loss(new_logprobs, adv, reduction)
        v = value_loss(new_values, batch["returns"], reduction)
        return pg + vf_coef * v - ent_coef * entropy.mean(), torch.stack([pg, v])

    return loss_fn


class A2C(PPO):
    """The ``a2c`` family's hooks: one epoch, A2C's loss, no log-probs stored."""

    loss_names = LOSS_NAMES
    stored = ()
    anneals = False

    @classmethod
    def make_program(cls, cfg, agent, optimizer, run, n_samples: int, device) -> UpdateProgram:
        bs = min(int(cfg.per_rank_batch_size), n_samples)
        if n_samples % bs != 0:
            warnings.warn(
                f"per_rank_batch_size ({bs}) does not divide the per-device sample count ({n_samples}); the "
                f"{n_samples % bs} samples at the shuffle tail are dropped"
            )
        return UpdateProgram(a2c_loss(cfg, run.cnn_keys, run.obs_keys, run.actions_dim, run.is_continuous),
                             select_rows, agent, optimizer, max_grad_norm=float(cfg.algo.max_grad_norm or 0.0),
                             epochs=1, n_samples=n_samples, batch_size=bs, n_metrics=len(cls.loss_names),
                             n_scalars=2, generator=run.generator, device=device)

    def scalars(self):
        return [0.0, 0.0]

    def update_data(self, rb, returns, advantages) -> Dict[str, Any]:
        data = super().update_data(rb, returns, advantages)
        data.pop("values")
        return data


@register_algorithm()
def main(fabric, cfg) -> Dict[str, Any]:
    """The A2C training run (see :func:`~sheeprl_tpu_torch.algos.ppo.ppo.train_loop`)."""
    run = open_run(fabric, cfg, "A2C")
    return train_loop(fabric, cfg, run, A2C(fabric, cfg, run))
