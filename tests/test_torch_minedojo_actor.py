"""The port's mask-aware MineDojo acting (``sheeprl_tpu_torch/algos/
dreamer_v3/minedojo_actor.py``) against the JAX package's at injected noise.

The JAX functions draw their noise from keys: ``sample_minedojo_actions``
splits its key in three, one a head, and samples with
``jax.random.categorical``, whose noise is ``jax.random.gumbel(key,
logits.shape)``; ``add_minedojo_exploration_noise`` splits its key in six,
a Gumbel draw and a uniform ``u`` a head. The test re-derives that noise
with JAX's own functions and hands it to the port as tensors; seeds are
never matched across the frameworks.

The batches hit every mask branch: action types forbidden, the craft head
masked only where the type is craft (15), the item head masked by
``mask_equip_place`` for equip and place (16, 17) and by ``mask_destroy``
for destroy (18), heads with no valid entry (uniform over all of their
entries, never NaN), and exploration that changes the type into 15-18 and
so redraws the argument heads. Tolerances: actions exactly (their argmax,
and their values to float32 rounding: a straight-through sample is ``one +
p - p``); masked logits and probabilities atol 1e-6 (float32, another
summation order in the softmax)."""

import jax
import jax.numpy as jnp
import numpy as np
import cpu_threads  # noqa: F401  (one CPU thread a process: see cpu_threads.py)
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import minedojo_actor as jax_md
from sheeprl_tpu_torch.algos.dreamer_v3 import minedojo_actor as md
from sheeprl_tpu_torch.distributions import OneHotCategorical

DIMS = (19, 16, 60)
N = 64
LOGIT_ATOL = 1e-6


def _masks(rng, n=N):
    """Masks over every branch: some rows forbid functional types, some have nothing to craft, equip or destroy,
    and the last rows forbid every entry of a head."""
    action_type = np.ones((n, DIMS[0]), bool)
    action_type[:, 15:] = rng.random((n, 4)) < 0.6
    craft = rng.random((n, DIMS[1])) < 0.3
    equip = rng.random((n, DIMS[2])) < 0.1
    destroy = rng.random((n, DIMS[2])) < 0.1
    craft[::5] = False
    equip[1::5] = False
    destroy[2::5] = False
    action_type[-1] = False  # no valid action type at all
    craft[-2:] = equip[-2:] = destroy[-2:] = False
    return {"mask_action_type": action_type, "mask_craft_smelt": craft, "mask_equip_place": equip,
            "mask_destroy": destroy}


def _logits(rng, n=N):
    return [rng.normal(size=(n, d)).astype(np.float32) * 2.0 for d in DIMS]


def _t(masks):
    return {k: torch.from_numpy(v) for k, v in masks.items()}


def _j(masks):
    return {k: jnp.asarray(v) for k, v in masks.items()}


def _sample_noise(key, logits):
    keys = jax.random.split(key, len(logits))
    return [torch.from_numpy(np.array(jax.random.gumbel(k, lg.shape, jnp.float32))) for k, lg in zip(keys, logits)]


def _expl_noise(key, actions):
    keys = jax.random.split(key, 2 * len(actions))
    return [(torch.from_numpy(np.array(jax.random.gumbel(keys[2 * i], a.shape, jnp.float32))),
             torch.from_numpy(np.array(jax.random.uniform(keys[2 * i + 1], a.shape[:-1] + (1,)))))
            for i, a in enumerate(actions)]


def _same_actions(port, jax_actions):
    for p, j in zip(port, jax_actions):
        j = np.asarray(j)
        np.testing.assert_array_equal(p.detach().numpy().argmax(-1), j.argmax(-1))
        np.testing.assert_allclose(p.detach().numpy(), j, atol=1e-6)


def test_masked_logits_match_jax_in_every_branch():
    rng = np.random.default_rng(0)
    masks = _masks(rng)
    logits = _logits(rng)
    np.testing.assert_array_equal(
        md.masked_action_type_logits(torch.from_numpy(logits[0]), _t(masks)).numpy(),
        np.asarray(jax_md.masked_action_type_logits(jnp.asarray(logits[0]), _j(masks))))
    functional = np.arange(N) % DIMS[0]  # every type, 15-18 included
    for head in (1, 2):
        got = md.masked_arg_logits(head, torch.from_numpy(logits[head]), torch.from_numpy(functional), _t(masks))
        want = jax_md.masked_arg_logits(head, jnp.asarray(logits[head]), jnp.asarray(functional), _j(masks))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        masked_rows = np.isin(functional, [15] if head == 1 else [16, 17, 18])
        assert (got.numpy()[~masked_rows] == logits[head][~masked_rows]).all()  # other types leave the head alone
    with pytest.raises(ValueError, match="heads 1 and 2"):
        md.masked_arg_logits(0, torch.zeros(1, 3), torch.zeros(1), _t(masks))


@pytest.mark.parametrize("is_training", [True, False], ids=["sampled", "greedy"])
@pytest.mark.parametrize("unimix", [0.01, 0.0])
def test_sampling_matches_jax_at_injected_noise(is_training, unimix):
    rng = np.random.default_rng(1)
    masks = _masks(rng)
    # half the rows pulled to craft, equip/place or destroy, so that the argument heads' masks bite
    logits = _logits(rng)
    pulled = rng.permutation(N)[: N // 2]
    logits[0][pulled, rng.integers(15, 19, pulled.size)] += 6.0
    key = jax.random.PRNGKey(7)
    j_actions, j_dists = jax_md.sample_minedojo_actions([jnp.asarray(x) for x in logits], _j(masks), key, unimix,
                                                        is_training)
    noise = _sample_noise(key, logits) if is_training else None
    actions, dists = md.sample_minedojo_actions([torch.from_numpy(x) for x in logits], _t(masks), unimix,
                                                is_training, noise=noise)
    _same_actions(actions, j_actions)
    for d, jd in zip(dists, j_dists):
        assert torch.isfinite(d.logits).all() and torch.isfinite(d.probs).all()
        np.testing.assert_allclose(d.probs.numpy(), np.asarray(jd.probs), atol=LOGIT_ATOL)
    types = actions[0].argmax(-1).numpy()
    assert masks["mask_action_type"][np.arange(N - 1), types[:-1]].all()  # valid wherever a type is
    # the row with no valid type is uniform over all 19, as in JAX, never NaN
    np.testing.assert_allclose(dists[0].probs[-1].numpy(), np.full(DIMS[0], 1.0 / DIMS[0]), atol=LOGIT_ATOL)
    crafted = types == 15
    assert crafted.any() and (types >= 16).any()
    for row in np.flatnonzero(crafted):
        if masks["mask_craft_smelt"][row].any():
            assert masks["mask_craft_smelt"][row, actions[1][row].argmax().item()]
        else:  # nothing craftable: the craft head is uniform over all entries
            np.testing.assert_allclose(dists[1].probs[row].numpy(), np.full(DIMS[1], 1.0 / DIMS[1]), atol=LOGIT_ATOL)
    for row in np.flatnonzero(types >= 16):
        mask = masks["mask_destroy" if types[row] == 18 else "mask_equip_place"][row]
        if mask.any():
            assert mask[actions[2][row].argmax().item()]


@pytest.mark.parametrize("expl_amount", [0.0, 0.5, 1.0])
def test_exploration_noise_matches_jax_at_injected_noise(expl_amount):
    rng = np.random.default_rng(2)
    masks = _masks(rng)
    # sampled actions mostly of the non-functional types, so that a redraw often turns them into 15-18
    types = rng.integers(0, 15, N)
    actions = [np.eye(DIMS[0], dtype=np.float32)[types]] + [
        np.eye(d, dtype=np.float32)[rng.integers(0, d, N)] for d in DIMS[1:]]
    key = jax.random.PRNGKey(11)
    j_out = jax_md.add_minedojo_exploration_noise([jnp.asarray(a) for a in actions], jnp.float32(expl_amount),
                                                  _j(masks), key)
    noise = _expl_noise(key, actions)
    out = md.add_minedojo_exploration_noise([torch.from_numpy(a) for a in actions], torch.tensor(expl_amount),
                                            _t(masks), noise)
    _same_actions(out, j_out)
    new_types = out[0].argmax(-1).numpy()
    if expl_amount == 0.0:
        for o, a in zip(out, actions):
            np.testing.assert_array_equal(o.numpy(), a)
        return
    changed = (new_types != types) & (new_types >= 15)
    assert changed.any()
    # a type changed into 15-18 redraws both argument heads (over their masks) even where their own u kept them
    for i in (1, 2):
        rows = changed & (noise[i][1].numpy()[:, 0] >= expl_amount)
        masked = md.masked_arg_logits(i, torch.zeros(N, DIMS[i]), torch.from_numpy(new_types), _t(masks))
        rand = OneHotCategorical(logits=masked).sample(gumbel=noise[i][0]).numpy()
        np.testing.assert_array_equal(out[i].numpy()[rows], rand[rows])
        assert rows.any() or expl_amount == 1.0
    valid_types = masks["mask_action_type"][np.arange(N - 1), new_types[:-1]]
    redrawn = noise[0][1].numpy()[:-1, 0] < expl_amount
    assert valid_types[redrawn].all()  # a redrawn type is a valid one


def test_the_minedojo_actor_class_is_the_actor():
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor

    assert issubclass(md.MinedojoActor, Actor)
    assert md.MASK_KEYS == ("mask_action_type", "mask_craft_smelt", "mask_equip_place", "mask_destroy")
