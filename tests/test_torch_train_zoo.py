"""Training of the MoE, vision-stub and encoder-decoder families
(qwen3-moe, mixtral, qwen2-vl with its ``vision_embeds``, whisper with its
``frames``) against the JAX package's: loss and gradients of one training
loss on each smoke config, with ``moe_groups=2``
(``tests/torch_train_zoo.py`` has the harness and states the tolerances).
The recurrent families are in ``test_torch_train_zoo_rec.py``."""
import pytest

from torch_train_zoo import check_parity


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x7b",
                                  "qwen2-vl-7b", "whisper-small"])
def test_loss_and_gradients_match_reference(arch):
    check_parity(arch)
