"""Shared checks of the port's training steps against the JAX package's
(tests/test_torch_train_*.py), on JAX-layout numpy trees: the port's
gradients and parameters go through ``utils.weights.state_dict_to_jax``, so
both sides are compared leaf by leaf under the JAX names.

Tolerances (float32 on both sides, other summation orders): loss rtol
1e-5; the clip's global norm rtol 1e-4; gradients and the parameters
after one step by ``chip_smoke.check_grads`` / ``check_params``, the one
statement of the rule, which the card-vs-CPU checks of chip_smoke.py use
too.
"""

import jax
import numpy as np
import optax

from chip_smoke import STEP_TOLS, check_grads, check_params
from videotofaces_tpu_torch.train.optim import leaves
from videotofaces_tpu_torch.utils.weights import flatten, state_dict_to_jax

LOSS_RTOL = STEP_TOLS["loss_rtol"]
GRAD_RTOL = STEP_TOLS["grad_rtol"]


def flat_np(tree):
    """{"a/b/c": numpy array} of a JAX or numpy tree."""
    return flatten(jax.tree.map(np.asarray, tree))


def port_grads(module, prefix=""):
    """The module's leaves' gradients as a flat JAX-layout numpy dict."""
    return flatten(state_dict_to_jax({prefix + k: t.grad for k, t in leaves(module)}))


def port_params(module):
    return flatten(state_dict_to_jax(module.state_dict()))


# the one statement of the rule, under the names the tests use
assert_grads_close, assert_params_after_step = check_grads, check_params


def jax_update(tx, grads, params):
    """The parameters after one optax update from a fresh state (jitted:
    op by op, optax takes seconds per update of a full-width tree here)."""
    def update(g, p):
        return optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])

    return jax.jit(update)(grads, params)
