"""Helpers for holding ``ra_tpu_torch`` against ``ra_tpu``.

Data crosses between the two packages only as numpy arrays: a JAX state
becomes a torch state through ``state_from_numpy``, and both are compared
field by field, exactly (every value is an integer or a bool).
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from ra_tpu.ops import consensus as J
from ra_tpu_torch.ops import consensus as T

# tier-1 runs several xdist workers on few cores
torch.set_num_threads(1)


def jax_fields(st) -> dict:
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def to_torch(st, device="cpu"):
    """The port's GroupState holding the JAX state's values."""
    return T.state_from_numpy(jax_fields(st), device)


def jax_copy(st):
    """A private copy for JAX entry points that donate their input."""
    return jax.tree.map(jnp.copy, st)


def mailbox_to_torch(mb) -> "T.Mailbox":
    return T.Mailbox(**{
        k: torch.from_numpy(np.array(np.asarray(v)))
        for k, v in mb._asdict().items()
    })


def assert_state_equal(jst, tst, where="") -> None:
    a = jax_fields(jst)
    b = T.state_to_numpy(tst)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k, a[k].dtype, b[k].dtype)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} field {k}")


def assert_egress_equal(jeg, teg, where="") -> None:
    for k, v in jeg._asdict().items():
        np.testing.assert_array_equal(
            np.asarray(v), getattr(teg, k).numpy(), err_msg=f"{where} egress {k}"
        )
