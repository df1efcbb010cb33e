"""The port's optimizer against the JAX package's on the CPU.

``sheeprl_tpu.utils.optim.Adam`` is ``optax.clip_by_global_norm`` chained
before ``optax.adamw`` (with weight decay) or ``optax.adam``. The port's
``Adam`` must give the same parameters after a few steps of the same
gradients, with the clip both engaged and not.

Tolerance: rtol 1e-5, atol 1e-7 (float32, a handful of element-wise steps).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.utils.optim import Adam as JaxAdam
from sheeprl_tpu_torch.utils.optim import Adam, clip_by_global_norm_, global_norm

TOL = dict(rtol=1e-5, atol=1e-7)
SHAPES = [(5, 3), (4,)]


def _grads(step, rng):
    # step 0's norm is far above the clip threshold of 1, the others below
    scale = 10.0 if step == 0 else 0.05
    return [(scale * rng.randn(*s)).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adam_and_clip_match_optax(weight_decay):
    rng = np.random.RandomState(0)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    tx = JaxAdam(lr=1e-2, eps=1e-5, weight_decay=weight_decay, max_grad_norm=1.0)
    jparams = [jnp.asarray(p) for p in init]
    jstate = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = Adam(params, lr=1e-2, eps=1e-5, weight_decay=weight_decay)
    for step in range(3):
        grads = _grads(step, rng)
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = clip_by_global_norm_([p.grad for p in params], 1.0)
        np.testing.assert_allclose(float(norm), float(optax.global_norm([jnp.asarray(g) for g in grads])), **TOL)
        opt.step()
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), **TOL)


def test_weight_decay_is_decoupled():
    """With weight decay the factory is AdamW: ``torch.optim.Adam``'s L2 term
    would go through the moment normalisation and give another step."""
    p = torch.nn.Parameter(torch.ones(3))
    assert isinstance(Adam([p], weight_decay=0.1), torch.optim.AdamW)
    assert type(Adam([p], weight_decay=0.0)) is torch.optim.Adam


def test_clip_leaves_small_gradients_alone():
    g = [torch.full((4,), 0.1)]
    norm = clip_by_global_norm_(g, 1.0)
    torch.testing.assert_close(norm, global_norm([torch.full((4,), 0.1)]))
    torch.testing.assert_close(g[0], torch.full((4,), 0.1), rtol=0, atol=0)
