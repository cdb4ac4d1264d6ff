"""The port's batched torch step functions against the JAX step kernels
over exhaustive small grids of (state, f, v), NIL included."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.models import kernels as JK
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.models import kernels as TK

NIL = int(JK.NIL)
VALUES = (NIL, 0, 1, 2, 3)
FS = tuple(range(9))          # every interned f id, F_NOOP and foreign ones


def _grid():
    rows = list(itertools.product(VALUES, FS, VALUES, VALUES))
    a = np.array(rows, np.int32)
    return a[:, :1], a[:, 1], a[:, 2:]


@pytest.mark.parametrize("name", ["cas-register", "register", "mutex"])
def test_step_matches_jax_over_exhaustive_grid(name):
    jk = {"cas-register": JK.cas_register_kernel(),
          "register": JK.register_kernel(),
          "mutex": JK.mutex_kernel()}[name]
    tk = {"cas-register": TK.cas_register_kernel(),
          "register": TK.register_kernel(),
          "mutex": TK.mutex_kernel()}[name]
    state, f, v = _grid()
    ok_j, new_j = jax.vmap(jk.step)(jnp.asarray(state), jnp.asarray(f),
                                    jnp.asarray(v))
    ok_t, new_t = tk.step(torch.from_numpy(state), torch.from_numpy(f),
                          torch.from_numpy(v))
    np.testing.assert_array_equal(np.asarray(ok_j), ok_t.numpy())
    np.testing.assert_array_equal(np.asarray(new_j), new_t.numpy())


def test_step_broadcasts_states_against_ops():
    # The dense tables evaluate [ns] states against [CH, w] ops at once.
    k = TK.cas_register_kernel()
    states = torch.tensor([0, 1, NIL]).view(1, 1, 3, 1)
    f = torch.tensor([[TK.F_READ, TK.F_WRITE, TK.F_CAS]]).unsqueeze(-1)
    v = torch.tensor([[[1, NIL], [2, NIL], [0, 3]]]).unsqueeze(2)
    ok, new = k.step(states, f, v)
    assert ok.shape == (1, 3, 3) and new.shape == (1, 3, 3, 1)
    assert ok[0, 0].tolist() == [False, True, False]   # read 1
    assert ok[0, 1].tolist() == [True, True, True]     # write 2
    assert new[0, 1, :, 0].tolist() == [2, 2, 2]
    assert ok[0, 2].tolist() == [True, False, False]   # cas 0 -> 3
    assert new[0, 2, 0, 0].item() == 3


def test_python_models_and_kernel_for():
    from jepsen_tpu_torch.history import invoke_op

    r = tm.cas_register(1)
    assert r.step(invoke_op(0, "cas", [1, 2])) == tm.CASRegister(2)
    assert tm.is_inconsistent(r.step(invoke_op(0, "cas", [3, 2])))
    assert tm.is_inconsistent(tm.register().step(invoke_op(0, "cas",
                                                           [1, 2])))
    assert tm.mutex().step(invoke_op(0, "acquire", None)).locked
    assert tm.is_inconsistent(tm.mutex().step(invoke_op(0, "release",
                                                        None)))
    assert TK.kernel_for(tm.Mutex(True)).init_state().tolist() == [1]
    assert TK.kernel_for(tm.register()).name == "register"
    assert TK.F_IDS == JK.F_IDS and int(TK.NIL) == NIL
    with pytest.raises(ValueError):
        TK.kernel_for(object())
