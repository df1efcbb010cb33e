"""The port's Plan2Explore on DreamerV3 against the JAX package on the CPU,
continuous actions: the walker's pixels and 24-wide state, 6 actions
through a ``trunc_normal`` actor that learns by dynamics backprop, so that
both actors' gradients run back through their imaginations. The checks and
tolerances of ``test_torch_p2e_dv3.py``."""

import pytest

from test_torch_p2e_dv3 import check_ensemble, check_exploration_step, make_jax_side


@pytest.fixture(scope="module")
def jax_side():
    return make_jax_side("continuous")


@pytest.mark.parametrize("tau", [0.02, 1.0])
def test_continuous_exploration_step_matches_jax(jax_side, tau):
    check_exploration_step(jax_side, tau)


def test_continuous_ensemble_intrinsic_reward_and_loss_match_jax(jax_side):
    check_ensemble(jax_side)
