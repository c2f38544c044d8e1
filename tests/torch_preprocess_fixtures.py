"""Shared helpers of the preprocessing-chain parity tests
(tests/test_torch_panoptic.py, tests/test_torch_siamrpn.py,
tests/test_torch_preprocess_tools.py).

A JAX net's variable tree comes from ``jax.eval_shape`` of its Flax
``init`` (no compile, no Flax init run) with leaves drawn by
``random_leaves``; the port takes it through the bridge
(``utils/convert.panoptic_from_jax`` / ``siamrpn_from_jax``). A submodule
goes through the same key map: its JAX tree is nested at the scope it has
in the whole net, and its port keys get the prefix they have there.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from c2m_tpu_torch.utils import convert
from tests.torch_port_fixtures import random_leaves


def nest(variables, *scope):
    """{'params': tree, ...} -> {'params': {scope[0]: {...: tree}}, ...}."""
    out = {}
    for coll, tree in variables.items():
        for name in reversed(scope):
            tree = {name: tree}
        out[coll] = tree
    return out


def jax_variables(module, *args, seed: int = 0, **kwargs):
    """Seeded numpy leaves for ``module.init(key, *args, **kwargs)``."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: module.init(key, *args, **kwargs))
    return random_leaves(shapes, seed)


def port_module(net, entry, variables, scope, prefix):
    """``net`` (eval mode) holding the JAX submodule's ``variables``, through
    the bridge's key map ``entry`` (``convert._panoptic_entry`` /
    ``_siamrpn_entry``)."""
    entries = convert._keyed_entries(net.state_dict(), entry, prefix)
    net.load_state_dict(convert._from_entries(net, entries,
                                              nest(variables, *scope)))
    return net.eval()


def nhwc(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


def jnp_list(xs):
    return [jnp.asarray(x) for x in xs]
