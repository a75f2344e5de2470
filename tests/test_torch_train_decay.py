"""The port's train step against the JAX package's ``losses.get_step_fn``
with coupled weight decay > 0 and a clip too large to act (f32, CPU,
``TINY_DDPM``), three steps from one randomised state under replayed t and
z.  Apart from tests/test_torch_train.py because each case compiles its
own JAX step.  Limits: ``tests/port_parity.py``."""

from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401


def test_three_train_steps_with_weight_decay_match_jax():
  port_parity.check_three_train_steps(port_parity.jax_train_side('decay'),
                                      'decay')
