"""The port's gradients of ``api.loss_fn`` for every family against the JAX
package's, on the CPU at the reduced configs.

Gradients against ``jax.grad`` of the JAX ``loss_fn`` at
``use_pallas=False`` (the Pallas kernel has no gradient), as per-leaf
relative norm errors:

* float32 compute, where the two attention backends differ only in sum
  order: at most 1e-5 (measured at most 1.0e-6 for the lm family, MoE and
  seamless, 3.8e-6 rwkv6, 6.7e-6 hymba's SSM projections).  MoE's router
  sum order (ROADMAP queue 3, item 9) does not limit it.  One leaf is held
  to 3e-5: rwkv6's bonus ``u`` (measured 1.2e-5), whose gradient sums
  B x T x D products that largely cancel, so the two sum orders part more
  relative to its norm.
* bf16 compute: ``ref.mha_chunked`` rounds p to bf16 before the value
  product and the port does not (queue 3, item 4), and every bf16 rounding
  of the forward reaches the gradient: at most 0.2 (measured 1.0e-2
  stablelm, 1.2e-2 MoE, 0.119 on hymba's SSM projections ``w_C`` and
  ``w_B``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

import jax.numpy as jnp

from repro.models import api as japi
from repro_torch.models import api
from repro_torch.train import optimizer as topt
from torch_train_cases import (FAMILIES, auto_mesh, configs, jax_batch,
                               numpy_batch, numpy_params, rel_errors,
                               torch_batch, trainable)


@pytest.fixture(scope="module")
def mesh():
    return auto_mesh()


# rwkv6's bonus u: its gradient sums B x T x D products that largely
# cancel, so the two sum orders part more relative to its norm
LEAF_BOUNDS = {("rwkv6-7b", "blocks/u"): 3e-5}


@pytest.mark.parametrize("arch, dtype, bound", [
    *((a, "float32", 1e-5) for a in FAMILIES),
    ("stablelm-1.6b", "bfloat16", 0.2),
    ("phi3.5-moe-42b-a6.6b", "bfloat16", 0.2),
    ("hymba-1.5b", "bfloat16", 0.2)])
def test_gradients_match_jax_grad(arch, dtype, bound, mesh):
    cfg, tcfg = configs(arch, dtype=dtype)
    tree, batch = numpy_params(cfg), numpy_batch(cfg)
    with mesh:
        (_, jm), jg = jax.jit(jax.value_and_grad(
            lambda p, b: japi.loss_fn(p, b, cfg), has_aux=True))(
            jax.tree.map(jnp.asarray, tree), jax_batch(batch))
    params = trainable(tree)
    total, tm = api.loss_fn(params, torch_batch(batch), tcfg)
    flat = [t for _, t in topt.leaves(params)]
    grads = dict(zip([k for k, _ in topt.leaves(params)],
                     torch.autograd.grad(total, flat)))
    errs = rel_errors(jg, _nest(grads))
    over = {k: e for k, e in errs.items()
            if e > LEAF_BOUNDS.get((arch, k), bound)}
    assert not over, over
    assert np.isclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-2)


def _nest(flat):
    """A ``path -> tensor`` dict as a nested tree (list indices as keys:
    ``optimizer.leaves`` gives the same paths)."""
    out = {}
    for key, t in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out
