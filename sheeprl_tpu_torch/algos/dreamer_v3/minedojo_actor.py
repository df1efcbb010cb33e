"""Mask-aware MineDojo acting (counterpart of
``sheeprl_tpu/algos/dreamer_v3/minedojo_actor.py``).

MineDojo hands out per-step validity masks (``mask_action_type``,
``mask_craft_smelt``, ``mask_equip_place``, ``mask_destroy``: see
``envs/minedojo.py``). The actor's three heads (action type, craft argument,
item argument) are sampled in order, so that

- an invalid action type is never selected,
- the craft head is masked by ``mask_craft_smelt`` only when the sampled
  action type is craft (15),
- the item head is masked by ``mask_equip_place`` for equip/place (16/17)
  and by ``mask_destroy`` for destroy (18).

The conditioning is branchless (``torch.where`` over the batch), so the
masked acting step replays from a CUDA graph. The uniform mix comes first,
then the mask; a masked logit is −1e9, not −inf, so that a head with no
valid entry is uniform over all of its entries (its logits normalise to
equal values), as in the JAX package, and never NaN. Noise is pre-drawn and
passed in: one Gumbel tensor ``[n, dim]`` a head for sampling, and for the
exploration draw one ``(gumbel [n, dim], u [n, 1])`` pair a head.

As in the JAX package, the dispatch is by the env wrapper's ``_target_``
(``algos/dreamer_v3/agent.py``), and the masks reach the acting path only:
not the imagination, evaluation or serving.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, uniform_mix
from sheeprl_tpu_torch.distributions import OneHotCategorical, OneHotCategoricalStraightThrough

__all__ = [
    "MASK_KEYS",
    "MinedojoActor",
    "add_minedojo_exploration_noise",
    "masked_action_type_logits",
    "masked_arg_logits",
    "sample_minedojo_actions",
]

_NEG_INF = -1e9  # softmax-safe: a head whose every entry is masked stays finite (uniform)

CRAFT_ACTION = 15
EQUIP_ACTION = 16
PLACE_ACTION = 17
DESTROY_ACTION = 18
MASK_KEYS = ("mask_action_type", "mask_craft_smelt", "mask_equip_place", "mask_destroy")


class MinedojoActor(Actor):
    """``algo.actor.cls`` for MineDojo: the DreamerV3 actor itself (the same
    heads and parameters), whose masked sampling the MineDojo wrapper's
    ``_target_`` selects, as in the JAX package."""


def _mask_logits(logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, logits, torch.full_like(logits, _NEG_INF))


def masked_action_type_logits(logits: torch.Tensor, masks: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Head 0: invalid action types are unreachable."""
    return _mask_logits(logits, masks["mask_action_type"].bool())


def masked_arg_logits(
    head: int, logits: torch.Tensor, functional_action: torch.Tensor, masks: Dict[str, torch.Tensor]
) -> torch.Tensor:
    """Heads 1 and 2, conditioned on the sampled action type (integer ids
    ``functional_action``), branchlessly over the batch."""
    if head == 1:
        is_craft = (functional_action == CRAFT_ACTION).unsqueeze(-1)
        return _mask_logits(logits, ~is_craft | masks["mask_craft_smelt"].bool())
    if head == 2:
        is_equip_place = ((functional_action == EQUIP_ACTION) | (functional_action == PLACE_ACTION)).unsqueeze(-1)
        is_destroy = (functional_action == DESTROY_ACTION).unsqueeze(-1)
        valid = (~is_equip_place | masks["mask_equip_place"].bool()) & (~is_destroy | masks["mask_destroy"].bool())
        return _mask_logits(logits, valid)
    raise ValueError(f"masked_arg_logits handles heads 1 and 2, got {head}")


def _masked(i: int, logits: torch.Tensor, functional_action, masks) -> torch.Tensor:
    if i == 0:
        return masked_action_type_logits(logits, masks)
    return masked_arg_logits(i, logits, functional_action, masks)


def sample_minedojo_actions(
    pre_dist: Sequence[torch.Tensor],
    masks: Optional[Dict[str, torch.Tensor]],
    unimix: float = 0.01,
    is_training: bool = True,
    noise: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[List[torch.Tensor], list]:
    """The three heads sampled in order with the mask conditioning: each
    head's logits take the uniform mix, then its mask; the action is a
    straight-through sample (its Gumbels ``noise[i]``, or drawn from
    ``generator``) or, greedily, the mode. Returns ``(actions, dists)``."""
    masks = masks or {}
    actions: List[torch.Tensor] = []
    dists = []
    functional_action = None
    for i, logits in enumerate(pre_dist):
        logits = uniform_mix(logits, logits.shape[-1], unimix)
        if masks:
            logits = _masked(i, logits, functional_action, masks)
        dist = OneHotCategoricalStraightThrough(logits=logits)
        if is_training:
            act = dist.rsample(generator, None if noise is None else noise[i].to(logits.device))
        else:
            act = dist.mode
        actions.append(act)
        dists.append(dist)
        if functional_action is None:
            functional_action = act.argmax(dim=-1)
    return actions, dists


def add_minedojo_exploration_noise(
    actions: Sequence[torch.Tensor],
    expl_amount: torch.Tensor,
    masks: Optional[Dict[str, torch.Tensor]],
    noise: Sequence[Tuple[torch.Tensor, torch.Tensor]],
) -> List[torch.Tensor]:
    """ε-exploration that keeps to the masks: a row's head becomes a uniform
    draw over its valid entries (``noise[i][0]``, Gumbels ``[n, dim]``) where
    ``noise[i][1] < expl_amount`` (``u [n, 1]``, the device scalar
    ``expl_amount``); when the action type changes into a functional one
    (craft, equip, place, destroy) the argument heads are redrawn too, so
    that the composite action stays consistent."""
    masks = masks or {}
    out: List[torch.Tensor] = []
    functional_action = actions[0].argmax(dim=-1)
    type_changed = None
    for i, act in enumerate(actions):
        logits = torch.zeros_like(act)
        if masks:
            logits = _masked(i, logits, functional_action, masks)
        gumbel, u = noise[i]
        rand = OneHotCategorical(logits=logits).sample(gumbel=gumbel.to(act.device))
        take = u.to(act.device) < expl_amount
        if i == 0:
            new0 = torch.where(take, rand, act)
            new_functional = new0.argmax(dim=-1)
            type_changed = (
                (new_functional != functional_action)
                & (new_functional >= CRAFT_ACTION)
                & (new_functional <= DESTROY_ACTION)
            ).unsqueeze(-1)
            functional_action = new_functional
            out.append(new0)
        else:
            out.append(torch.where(take | type_changed, rand, act))
    return out
