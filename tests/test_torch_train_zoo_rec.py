"""Training of the recurrent families (rwkv6 through ``WKV6Function``,
recurrentgemma) against the JAX package's: loss and gradients of one
training loss on each smoke config (``tests/torch_train_zoo.py`` has the
harness and states the tolerances). The other families are in
``test_torch_train_zoo.py``."""
import pytest

from torch_train_zoo import check_parity


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b"])
def test_loss_and_gradients_match_reference(arch):
    check_parity(arch)
